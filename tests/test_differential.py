"""Differential tests: byte-compare our outputs against the reference
binary (if available) across flag combinations on synthetic data.

These only run where a compiled reference binary exists (built into
/tmp/refbuild by the development environment); they are skipped
elsewhere. The golden-file tests in test_overlap.py/test_dedup.py cover
the committed expectations.
"""

import os
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


def run_ref(args, cwd):
    r = subprocess.run(
        [REF_BIN, *args], capture_output=True, text=True, cwd=cwd
    )
    assert r.returncode == 0, f"ref failed: {r.stderr}"
    return r


def run_ours(args, cwd):
    r = subprocess.run(
        [sys.executable, "-m", "compairr_tpu", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        env={
            **os.environ,
            "PYTHONPATH": REPO + ":" + os.environ.get("PYTHONPATH", ""),
        },
    )
    assert r.returncode == 0, f"ours failed: {r.stderr}"
    return r


def compare_outputs(tmp_path, inputs, flags, pairs=False):
    ref_out = tmp_path / "ref_out.tsv"
    our_out = tmp_path / "our_out.tsv"
    ref_args = [*flags, *inputs, "-o", str(ref_out)]
    our_args = [*flags, *inputs, "-o", str(our_out)]
    if pairs:
        ref_pairs = tmp_path / "ref_pairs.tsv"
        our_pairs = tmp_path / "our_pairs.tsv"
        ref_args += ["-p", str(ref_pairs)]
        our_args += ["-p", str(our_pairs)]
    run_ref(ref_args, str(tmp_path))
    run_ours(our_args, str(tmp_path))
    assert our_out.read_text() == ref_out.read_text(), f"flags={flags}"
    if pairs:
        assert (
            our_pairs.read_text() == ref_pairs.read_text()
        ), f"pairs flags={flags}"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    a = make_tsv(str(d / "a.tsv"), 300, 4, seed=1)
    b = make_tsv(str(d / "b.tsv"), 400, 5, seed=2)
    return d, a, b


@pytest.mark.parametrize(
    "flags",
    [
        ["-m", "-d", "0"],
        ["-m", "-d", "1"],
        ["-m", "-d", "1", "-i"],
        ["-m", "-d", "2"],
        ["-m", "-d", "3"],
        ["-m", "-d", "1", "-g"],
        ["-m", "-d", "1", "-f"],
        ["-m", "-d", "1", "-a"],
        ["-m", "-d", "2", "-s", "ratio"],
        ["-m", "-d", "1", "-s", "min"],
        ["-m", "-d", "1", "-s", "max"],
        ["-m", "-d", "1", "-s", "mean"],
        ["-m", "-d", "0", "-s", "MH"],
        ["-m", "-d", "0", "-s", "Jaccard"],
        ["-m", "-d", "1", "-n"],
    ],
)
def test_matrix_two_sets(data, tmp_path, flags):
    _, a, b = data
    compare_outputs(tmp_path, [a, b], flags)


@pytest.mark.parametrize(
    "flags",
    [
        ["-m", "-d", "0"],
        ["-m", "-d", "1", "-i"],
        ["-m", "-d", "2"],
    ],
)
def test_matrix_self(data, tmp_path, flags):
    _, a, _b = data
    compare_outputs(tmp_path, [a], flags)


def test_pairs_file_self_d3(data, tmp_path):
    # d>2 pairs emit per seed in set-2 index order, not variant order
    # (process_trad, overlap.cc:286-359) — regression for fuzz trial 45
    _, a, _b = data
    compare_outputs(
        tmp_path, [a], ["-m", "-d", "3", "-g", "--distance"], pairs=True
    )
    compare_outputs(tmp_path, [a], ["-m", "-d", "3", "--distance"],
                    pairs=True)


@pytest.mark.parametrize(
    "flags",
    [
        ["-m", "-d", "1"],
        ["-m", "-d", "1", "-i", "--distance"],
        ["-m", "-d", "2", "--distance"],
        ["-m", "-d", "1", "-k", "colx,coly"],
    ],
)
def test_pairs_file(data, tmp_path, flags):
    _, a, b = data
    compare_outputs(tmp_path, [a, b], flags, pairs=True)


@pytest.mark.parametrize(
    "flags",
    [
        ["-c", "-d", "1"],
        ["-c", "-d", "1", "-i"],
        ["-c", "-d", "2"],
        ["-c", "-d", "1", "-g"],
        ["-c", "-d", "3"],
        ["-c", "-d", "1", "-n"],
    ],
)
def test_cluster(data, tmp_path, flags):
    _, a, _b = data
    compare_outputs(tmp_path, [a], flags)


@pytest.mark.parametrize(
    "flags",
    [
        ["-z"],
        ["-z", "-g"],
        ["-z", "-f"],
        ["-z", "-n"],
    ],
)
def test_dedup(data, tmp_path, flags):
    _, a, _b = data
    compare_outputs(tmp_path, [a], flags)


def test_existence(data, tmp_path):
    d, _a, b = data
    # existence set 1: single repertoire, sequence_id required
    c = make_tsv(str(d / "c.tsv"), 50, 1, seed=3)
    compare_outputs(tmp_path, [c, b], ["-x", "-d", "1"])
    compare_outputs(tmp_path, [c, b], ["-x", "-d", "1", "-a"])
    compare_outputs(tmp_path, [c, b], ["-x", "-d", "0", "-f"], pairs=True)


def normalized_log(text: str) -> str:
    """Log text with volatile content masked: the two banner lines
    (intentionally different), wall-clock timestamps, and per-phase
    timings. Everything else — option echo, stats blocks, repertoire
    tables, warnings, progress prompts, unique-gene counts — must be
    byte-identical to the reference."""
    import re

    lines = text.splitlines(True)[2:]  # banner + URL line
    out = []
    for ln in lines:
        if ln.startswith(("Start time:", "End time:")):
            out.append(ln.split(":")[0] + ": MASKED\n")
            continue
        out.append(re.sub(r"\(\d+(\.\d+)?s\)", "(T)", ln))
    return "".join(out)


@pytest.mark.parametrize(
    "flags,two_sets",
    [
        (["-m", "-d", "1", "-i"], True),
        (["-m", "-d", "2"], False),
        (["-x", "-d", "1"], "existence"),
        (["-c", "-d", "1"], False),
        (["-z"], False),
    ],
)
def test_log_parity(data, tmp_path, flags, two_sets):
    """Normalized -l log differential: pins the whole log format
    (option echo, stats, repertoire tables, progress prompts,
    warnings) against the reference for one flag combo per command."""
    d, a, b = data
    if two_sets == "existence":
        inputs = [make_tsv(str(d / "cx.tsv"), 50, 1, seed=7), b]
    elif two_sets:
        inputs = [a, b]
    else:
        inputs = [a]
    # same log path for both so the echoed "Log file (l):" line — part
    # of the pinned format — matches too
    log = tmp_path / "run.log"
    run_ref([*flags, *inputs, "-o", os.devnull, "-l", str(log)],
            str(tmp_path))
    ref_text = log.read_text()
    run_ours([*flags, *inputs, "-o", os.devnull, "-l", str(log)],
             str(tmp_path))
    assert normalized_log(log.read_text()) == normalized_log(
        ref_text
    ), f"log mismatch for {flags}"


@pytest.mark.skipif(
    os.environ.get("COMPAIRR_SLOW_TESTS") != "1",
    reason="large-scale differential (~2 min ref run); "
    "COMPAIRR_SLOW_TESTS=1 enables",
)
def test_large_scale_d2_byte_identity():
    """Mid-scale d=2 self-compare byte-identity (matrix + pairs) via
    scripts/diff_large_d2.py — the double-substitution enumeration
    (/root/reference/src/variants.cc:357-400) verified beyond fuzz
    scale. The full record: 1.5M rows d=2 and 50k rows d=3, both
    matrix+pairs byte-identical (BASELINE.md, round 4)."""
    r = subprocess.run(
        [sys.executable, "scripts/diff_large_d2.py", "200000", "2",
         "--pairs"],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MISMATCH" not in r.stdout
