"""Keck-scale demo: generate a 24.2M-sequence synthetic repertoire set
(matching the reference README's headline benchmark shape:
/root/reference/README.md:726-755) and race this framework against the
reference binary with byte-comparison.

Usage:
    python scripts/scale_demo.py [N] [--ref /path/to/compairr] [-d D] [-i]

Timings on the GPU are recorded in PERF.md.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

AA = "ACDEFGHIKLMNPQRSTVWY"


def generate(path: str, n: int, reps: int = 120, nv: int = 50,
             nj: int = 13, seed: int = 42) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write(
            "repertoire_id\tsequence_id\tduplicate_count\tv_call\t"
            "j_call\tjunction_aa\n"
        )
        chunk = 500_000
        for s0 in range(0, n, chunk):
            m = min(chunk, n - s0)
            lens = np.clip(
                np.round(rng.normal(14.5, 1.8, size=m)), 9, 22
            ).astype(np.int64)
            rs = rng.integers(0, reps, size=m)
            vs = rng.integers(0, nv, size=m)
            js = rng.integers(0, nj, size=m)
            cnts = rng.integers(1, 50, size=m)
            res = rng.integers(0, 20, size=(m, 22))
            rows = []
            for k in range(m):
                s = "".join(AA[c] for c in res[k, : lens[k]])
                i = s0 + k
                rows.append(
                    f"R{rs[k]:03d}\tS{i}\t{cnts[k]}\tTRBV{vs[k]}\t"
                    f"TRBJ{js[k]}\t{s}"
                )
            f.write("\n".join(rows) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=24_205_557)
    ap.add_argument("--ref", default="/tmp/refbuild/src/compairr")
    ap.add_argument("-d", type=int, default=1)
    ap.add_argument("-i", action="store_true")
    ap.add_argument("--workdir", default="/tmp/scale_demo")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    data = os.path.join(args.workdir, f"data_{args.n}.tsv")
    if not os.path.exists(data):
        print(f"generating {args.n} sequences ...", flush=True)
        t = time.perf_counter()
        generate(data, args.n)
        print(f"  {time.perf_counter() - t:.0f}s", flush=True)

    flags = ["-m", "-d", str(args.d)] + (["-i"] if args.i else [])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "compairr_tpu", *flags, data,
         "-o", os.path.join(args.workdir, "ours.tsv")],
        cwd=repo,
    )
    print(f"ours: {time.perf_counter() - t:.0f}s rc={r.returncode}",
          flush=True)

    if os.path.exists(args.ref):
        t = time.perf_counter()
        r = subprocess.run(
            [args.ref, *flags, data, "-o",
             os.path.join(args.workdir, "ref.tsv")],
        )
        print(f"reference: {time.perf_counter() - t:.0f}s "
              f"rc={r.returncode}", flush=True)
        ours = open(os.path.join(args.workdir, "ours.tsv")).read()
        ref = open(os.path.join(args.workdir, "ref.tsv")).read()
        print("byte-identical:", ours == ref, flush=True)
    else:
        print(f"reference binary not found at {args.ref}; skipped",
              flush=True)


if __name__ == "__main__":
    main()
