import subprocess
import sys

import pytest

from conftest import REF_TEST_DIR, REPO

EXAMPLE4_EXPECTED = """repertoire_id\tduplicate_count\tv_call\tj_call\tjunction_aa
B1\t5\tTCRBV07-09\tTCRBJ01-02\tCASSLRVGGYGYTF
B1\t10\tTCRBV07-09\tTCRBJ01-02\tCASSLRVGGFGYTF
B2\t7\tTCRBV07-06\tTCRBJ02-01\tCASSTSHQQYF
"""


def run_cli(args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "compairr_tpu", *args],
        capture_output=True,
        text=True,
        cwd=cwd,
    )


def test_dedup_readme_example4(tmp_path):
    """README.md:648-708 (Example 4): -z setb.tsv byte-matches."""
    out = tmp_path / "output.tsv"
    r = run_cli(["-z", f"{REF_TEST_DIR}/setb.tsv", "-o", str(out)], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert out.read_text() == EXAMPLE4_EXPECTED
    assert "Duplicates merged: 0" in r.stderr


def test_dedup_merges_counts(tmp_path):
    src = tmp_path / "in.tsv"
    src.write_text(
        "repertoire_id\tsequence_id\tduplicate_count\tv_call\tj_call\tjunction_aa\n"
        "A\tS1\t5\tV1\tJ1\tCASSF\n"
        "A\tS2\t7\tV1\tJ1\tCASSG\n"
        "A\tS3\t10\tV1\tJ1\tCASSF\n"
        "B\tS4\t2\tV1\tJ1\tCASSF\n"
    )
    out = tmp_path / "out.tsv"
    r = run_cli(["-z", str(src), "-o", str(out)], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert out.read_text() == (
        "repertoire_id\tduplicate_count\tv_call\tj_call\tjunction_aa\n"
        "A\t15\tV1\tJ1\tCASSF\n"
        "A\t7\tV1\tJ1\tCASSG\n"
        "B\t2\tV1\tJ1\tCASSF\n"
    )
    assert "Duplicates merged: 1" in r.stderr


def test_dedup_ignore_counts_and_genes(tmp_path):
    src = tmp_path / "in.tsv"
    src.write_text(
        "repertoire_id\tsequence_id\tduplicate_count\tv_call\tj_call\tjunction_aa\n"
        "A\tS1\t5\tV1\tJ1\tCASSF\n"
        "A\tS3\t10\tV2\tJ1\tCASSF\n"
    )
    out = tmp_path / "out.tsv"
    r = run_cli(["-z", str(src), "-f", "-g", "-o", str(out)], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert out.read_text() == (
        "repertoire_id\tduplicate_count\tjunction_aa\n" "A\t2\tCASSF\n"
    )


def test_cli_validation_errors():
    # no command
    r = run_cli([], cwd=REPO)
    assert r.returncode == 1
    assert "Please specify a command" in r.stderr
    # two commands
    r = run_cli(["-m", "-c", "x.tsv"], cwd=REPO)
    assert "just one command" in r.stderr
    # dedup with -d
    r = run_cli(["-z", "-d", "1", "x.tsv"], cwd=REPO)
    assert "must be 0 for deduplication" in r.stderr
    # indels require d=1
    r = run_cli(["-m", "-i", "x.tsv"], cwd=REPO)
    assert "Indels are only allowed when d=1" in r.stderr
    # keep-columns requires pairs
    r = run_cli(["-m", "-k", "abc", "x.tsv"], cwd=REPO)
    assert "only allowed with --pairs" in r.stderr
    # bad score
    r = run_cli(["-m", "-s", "bogus", "x.tsv"], cwd=REPO)
    assert "must be MH, Jaccard, product" in r.stderr
    # MH at d>0
    r = run_cli(["-m", "-s", "MH", "-d", "1", "x.tsv"], cwd=REPO)
    assert "not defined when d>0" in r.stderr
    # MH in existence mode
    r = run_cli(["-x", "-s", "MH", "a.tsv", "b.tsv"], cwd=REPO)
    assert "only allowed when computing repertoire overlap" in r.stderr
    # duplicate option
    r = run_cli(["-m", "-d", "1", "-d", "2", "x.tsv"], cwd=REPO)
    assert "specified more than once" in r.stderr
    # threads range
    r = run_cli(["-m", "-t", "999", "x.tsv"], cwd=REPO)
    assert "range 1 to 256" in r.stderr
    # cluster forbids pairs
    r = run_cli(["-c", "-p", "p.tsv", "x.tsv"], cwd=REPO)
    assert "not allowed with -c or --cluster" in r.stderr


def test_cli_version_and_help():
    r = run_cli(["-v"], cwd=REPO)
    assert r.returncode == 0
    r = run_cli(["--help"], cwd=REPO)
    assert r.returncode == 0
    assert "Usage:" in r.stderr
