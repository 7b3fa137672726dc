"""Full Keck-scale measured sweep vs the reference binary.

Measures every Keck mode (-m -d 0/1/2, -m -d 1 -i, -c, -z, -x) on the
SHIPPED code with the same-window interleaved protocol (ref, ours, ref,
ours — min per side), byte-comparing outputs on every mode where both
sides run. Reference bar: the published /usr/bin/time protocol of the
reference README's "Performance" section.

Inputs: the 24.2M-row Keck-synthetic TSV written by
scripts/diff_large_d2.py (reused verbatim), plus derived 8M / 10k
subsets for dedup and existence.

Usage:
  python scripts/keck_sweep.py [--rounds 2] [--modes m0,m1,m1i,...]

Prints one JSON line per measurement and a final summary JSON; files
under /tmp/keck_sweep/.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REF = "/tmp/refbuild/src/compairr"
OURS = os.path.join(REPO, "bin", "compairr")
KECK = "/tmp/diff_large_24205557_d2/input.tsv"
OUT = "/tmp/keck_sweep"


def _subset(src: str, dst: str, n_rows: int, one_rep: bool = False) -> str:
    """First n_rows rows of src; with one_rep, only the first
    repertoire's rows (the -x/--existence command rejects multiple
    repertoires in file 1)."""
    if os.path.exists(dst):
        return dst
    t0 = time.time()
    rep = None
    kept = 0
    with open(src, "rb") as f, open(dst, "wb", buffering=1 << 22) as g:
        g.write(f.readline())  # header
        for line in f:
            if one_rep:
                r = line.split(b"\t", 1)[0]
                if rep is None:
                    rep = r
                elif r != rep:
                    continue
            g.write(line)
            kept += 1
            if kept >= n_rows:
                break
    sys.stderr.write(
        f"subset {dst} ({kept} rows) in {time.time() - t0:.0f}s\n"
    )
    return dst


def run_timed(tag: str, cmd: list, env_extra=None) -> float:
    env = dict(os.environ)
    if env_extra:
        env.update(env_extra)
    t0 = time.perf_counter()
    r = subprocess.run(
        cmd, env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        print(json.dumps({"tag": tag, "error": r.returncode}))
        return float("nan")
    print(json.dumps({"tag": tag, "wall_s": round(wall, 2)}), flush=True)
    return wall


MODES = {
    # name: (flags, needs_two_inputs, ref_too)
    "m0": (["-m", "-d", "0"], "self", True),
    "m1": (["-m", "-d", "1"], "self", True),
    "m1i": (["-m", "-d", "1", "-i"], "self", True),
    "m2": (["-m", "-d", "2"], "self", False),  # ref published: 3200 s
    "cluster": (["-c", "-d", "1"], "one", True),
    "dedup": (["-z"], "dedup8m", True),
    "exist": (["-x", "-d", "1"], "exist", True),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--modes", default="m0,m1,m1i,m2,cluster,dedup,exist")
    ap.add_argument("--input", default=KECK)
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    assert os.path.exists(args.input), "run scripts/diff_large_d2.py first"
    eight_m = os.path.join(OUT, "keck8m.tsv")
    ten_k = os.path.join(OUT, "keck10k.tsv")

    summary = {}
    for name in args.modes.split(","):
        flags, shape, ref_too = MODES[name]
        if shape == "self":
            inputs = [args.input, args.input]
        elif shape == "one":
            inputs = [args.input]
        elif shape == "dedup8m":
            inputs = [_subset(args.input, eight_m, 8_000_000)]
        else:  # exist
            inputs = [
                _subset(args.input, ten_k, 10_000, one_rep=True),
                _subset(args.input, eight_m, 8_000_000),
            ]
        ref_out = os.path.join(OUT, f"{name}_ref.tsv")
        our_out = os.path.join(OUT, f"{name}_our.tsv")
        walls_ref, walls_our = [], []
        for rnd in range(args.rounds):
            if ref_too:
                walls_ref.append(run_timed(
                    f"{name}/ref[{rnd}]",
                    [REF, *flags, *inputs, "-o", ref_out,
                     "-l", os.path.join(OUT, f"{name}_ref.log")],
                ))
            walls_our.append(run_timed(
                f"{name}/ours[{rnd}]",
                [OURS, *flags, *inputs, "-o", our_out,
                 "-l", os.path.join(OUT, f"{name}_our.log")],
            ))
        entry = {"ours_s": min(walls_our), "ours_all": walls_our}
        if ref_too:
            entry.update(ref_s=min(walls_ref), ref_all=walls_ref)
            same = (
                open(ref_out, "rb").read() == open(our_out, "rb").read()
            )
            entry["byte_identical"] = same
        summary[name] = entry
        print(json.dumps({name: entry}), flush=True)
        # big per-row outputs (cluster/dedup) are compared above;
        # drop them to keep /tmp bounded
        for p in (ref_out, our_out):
            if os.path.exists(p) and os.path.getsize(p) > 1 << 26:
                os.unlink(p)

    print(json.dumps({"keck_sweep": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
