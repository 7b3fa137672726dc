"""Randomized differential fuzz vs the reference binary.

A compact in-suite version of the wider sweeps run during development
(60-80 trials across commands, distances, score modes, nucleotides,
dirty inputs with -u/-e, keep-columns): every trial runs both CLIs on
fresh synthetic data and byte-compares outputs (and pairs files), or
asserts matching exit codes when both reject the input. Self-skips
without the compiled reference binary.
"""

import os
import random
import subprocess
import sys

import pytest

from conftest import REPO
from synth import make_tsv

REF_BIN = "/tmp/refbuild/src/compairr"

pytestmark = [
    pytest.mark.skipif(
        not os.path.exists(REF_BIN),
        reason="reference binary not available",
    ),
    pytest.mark.slow,
]


def _one_trial(tmp_path, it: int) -> None:
    rng = random.Random(9000 + it)
    n1 = rng.choice([1, 9, 250, 700])
    n2 = rng.choice([1, 13, 400])
    reps1 = rng.choice([1, 3, 10])
    reps2 = rng.choice([1, 5])
    sub = rng.choice([4, 8, 20])
    nt = rng.random() < 0.25
    a = make_tsv(
        str(tmp_path / "a.tsv"), n1, reps1, seed=100 + it,
        alphabet_sub=sub, nt=nt,
    )
    b = make_tsv(
        str(tmp_path / "b.tsv"), n2, reps2, seed=200 + it,
        alphabet_sub=sub, nt=nt,
    )

    def corrupt(path, seed):
        r2 = random.Random(seed)
        lines = open(path).read().splitlines()
        for k in range(1, len(lines)):
            if r2.random() < 0.05:
                f = lines[k].split("\t")
                col = 5 if nt else 6
                f[col] = "" if r2.random() < 0.5 else f[col][:3] + "xXz"
                lines[k] = "\t".join(f)
        open(path, "w").write("\n".join(lines) + "\n")

    dirty = rng.random() < 0.3
    if dirty:
        corrupt(a, 300 + it)
        corrupt(b, 400 + it)

    cmd = rng.choice(["-m", "-m", "-x", "-c", "-z"])
    flags = [cmd]
    if nt:
        flags.append("-n")
    if dirty:
        if rng.random() < 0.7:
            flags.append("-u")
        if rng.random() < 0.7:
            flags.append("-e")
    if cmd != "-z":
        d = rng.choice([0, 1, 1, 2, 3])
        flags += ["-d", str(d)]
        if d == 1 and rng.random() < 0.5:
            flags.append("-i")
    if rng.random() < 0.3:
        flags.append("-g")
    if rng.random() < 0.3:
        flags.append("-f")
    if cmd in ("-m", "-x") and rng.random() < 0.4:
        flags += ["-s", rng.choice(["ratio", "min", "max", "mean"])]
    pairs = cmd in ("-m", "-x") and rng.random() < 0.5
    if pairs and rng.random() < 0.5:
        flags.append("--distance")
    if pairs and rng.random() < 0.4:
        flags += ["-k", rng.choice(["colx", "colx,coly"])]
    if cmd == "-x":
        a = make_tsv(
            str(tmp_path / "a.tsv"), n1, 1, seed=500 + it,
            alphabet_sub=sub, nt=nt,
        )
        if dirty:
            corrupt(a, 600 + it)
        inputs = [a, b]
    elif cmd in ("-c", "-z"):
        inputs = [a]
    else:
        inputs = [a, b] if rng.random() < 0.8 else [a]

    # dense-engine trials: matrix runs without pairs files, excluding
    # ratio scores (inherently f32-rounded on the dense path; every
    # other mode must stay byte-exact under the exactness guard)
    dense = (
        cmd == "-m"
        and not pairs
        and "ratio" not in flags
        and rng.random() < 0.35
    )

    ref_args = [REF_BIN, *flags, *inputs, "-o", str(tmp_path / "ref.tsv")]
    our_args = [
        sys.executable, "-m", "compairr_tpu", *flags, *inputs,
        "-o", str(tmp_path / "our.tsv"),
    ]
    if pairs:
        ref_args += ["-p", str(tmp_path / "refp.tsv")]
        our_args += ["-p", str(tmp_path / "ourp.tsv")]
    r1 = subprocess.run(ref_args, capture_output=True, text=True)
    env = {
        **os.environ,
        "PYTHONPATH": REPO + ":" + os.environ.get("PYTHONPATH", ""),
    }
    if dense:
        env["COMPAIRR_ENGINE"] = "dense"
    else:
        env.pop("COMPAIRR_ENGINE", None)
    r2 = subprocess.run(
        our_args, capture_output=True, text=True, cwd="/root/repo",
        env=env,
    )
    assert r1.returncode == r2.returncode, (
        f"flags={flags} ref rc={r1.returncode} ours rc={r2.returncode}\n"
        f"ref: {r1.stderr[-300:]}\nours: {r2.stderr[-300:]}"
    )
    if r1.returncode != 0:
        return
    assert (tmp_path / "our.tsv").read_text() == (
        tmp_path / "ref.tsv"
    ).read_text(), f"flags={flags}"
    if pairs:
        assert (tmp_path / "ourp.tsv").read_text() == (
            tmp_path / "refp.tsv"
        ).read_text(), f"pairs flags={flags}"


@pytest.mark.parametrize("it", range(8))
def test_fuzz_trial(tmp_path, it):
    _one_trial(tmp_path, it)


def test_cluster_native_bfs_matches_python(tmp_path):
    """Cluster output is identical with the native BFS and the Python
    fallback (COMPAIRR_NATIVE_IO=0 disables all native paths)."""
    a = make_tsv(str(tmp_path / "a.tsv"), 500, 4, seed=901, alphabet_sub=5)
    outs = []
    for native in ("1", "0"):
        out = tmp_path / f"c{native}.tsv"
        r = subprocess.run(
            [sys.executable, "-m", "compairr_tpu", "-c", "-d", "1", "-i",
             a, "-o", str(out)],
            capture_output=True, text=True, cwd="/root/repo",
            env={**os.environ, "PYTHONPATH": "/root/repo",
                 "COMPAIRR_NATIVE_IO": native},
        )
        assert r.returncode == 0, r.stderr
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") > 400
