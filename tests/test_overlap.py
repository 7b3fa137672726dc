import subprocess
import sys

from conftest import REF_TEST_DIR, REPO


def run_cli(args):
    return subprocess.run(
        [sys.executable, "-m", "compairr_tpu", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
    )


def test_matrix_d1_indels_expected_tsv(tmp_path):
    """The reference's own integration test (test/test.sh:9): byte-match
    test/expected.tsv for -m seta setb -d 1 -i."""
    out = tmp_path / "output.tsv"
    log = tmp_path / "compairr.log"
    r = run_cli(
        [
            "-m",
            f"{REF_TEST_DIR}/seta.tsv",
            f"{REF_TEST_DIR}/setb.tsv",
            "-d",
            "1",
            "-i",
            "-l",
            str(log),
            "-o",
            str(out),
        ]
    )
    assert r.returncode == 0, r.stderr
    expected = open(f"{REF_TEST_DIR}/expected.tsv").read()
    assert out.read_text() == expected


def test_matrix_d1_readme_example1(tmp_path):
    """README.md Example 1: -m seta setb -d 1 with pairs file."""
    out = tmp_path / "output.tsv"
    pairs = tmp_path / "pairs.tsv"
    r = run_cli(
        [
            "-m",
            f"{REF_TEST_DIR}/seta.tsv",
            f"{REF_TEST_DIR}/setb.tsv",
            "-d",
            "1",
            "-o",
            str(out),
            "-p",
            str(pairs),
        ]
    )
    assert r.returncode == 0, r.stderr
    assert out.read_text() == "#\tB1\tB2\nA1\t0\t7\nA2\t45\t0\n"
    assert pairs.read_text() == (
        "#repertoire_id_1\tsequence_id_1\tduplicate_count_1\tv_call_1\t"
        "j_call_1\tjunction_aa_1\trepertoire_id_2\tsequence_id_2\t"
        "duplicate_count_2\tv_call_2\tj_call_2\tjunction_aa_2\n"
        "A1\tR\t1\tTCRBV07-06\tTCRBJ02-01\tCASSTSHEQYF\tB2\tV\t7\t"
        "TCRBV07-06\tTCRBJ02-01\tCASSTSHQQYF\n"
        "A2\tS\t3\tTCRBV07-09\tTCRBJ01-02\tCASSLRVGGYGYTF\tB1\tT\t5\t"
        "TCRBV07-09\tTCRBJ01-02\tCASSLRVGGYGYTF\n"
        "A2\tS\t3\tTCRBV07-09\tTCRBJ01-02\tCASSLRVGGYGYTF\tB1\tU\t10\t"
        "TCRBV07-09\tTCRBJ01-02\tCASSLRVGGFGYTF\n"
    )


def test_existence_d1_readme_example2(tmp_path):
    """README.md Example 2: -x setc setb -d 1 -f with pairs file."""
    out = tmp_path / "output.tsv"
    pairs = tmp_path / "pairs.tsv"
    r = run_cli(
        [
            "-x",
            f"{REF_TEST_DIR}/setc.tsv",
            f"{REF_TEST_DIR}/setb.tsv",
            "-d",
            "1",
            "-f",
            "-o",
            str(out),
            "-p",
            str(pairs),
        ]
    )
    assert r.returncode == 0, r.stderr
    assert out.read_text() == "#\tB1\tB2\nX\t2\t0\nY\t0\t1\n"
    assert pairs.read_text() == (
        "#repertoire_id_1\tsequence_id_1\tduplicate_count_1\tv_call_1\t"
        "j_call_1\tjunction_aa_1\trepertoire_id_2\tsequence_id_2\t"
        "duplicate_count_2\tv_call_2\tj_call_2\tjunction_aa_2\n"
        "C\tX\t1\tTCRBV07-09\tTCRBJ01-02\tCASSLRVGGFGYTF\tB1\tU\t10\t"
        "TCRBV07-09\tTCRBJ01-02\tCASSLRVGGFGYTF\n"
        "C\tX\t1\tTCRBV07-09\tTCRBJ01-02\tCASSLRVGGFGYTF\tB1\tT\t5\t"
        "TCRBV07-09\tTCRBJ01-02\tCASSLRVGGYGYTF\n"
        "C\tY\t1\tTCRBV07-06\tTCRBJ02-01\tCASSTSHQQYF\tB2\tV\t7\t"
        "TCRBV07-06\tTCRBJ02-01\tCASSTSHQQYF\n"
    )


def test_cluster_readme_example3(tmp_path):
    """README.md Example 3: -c setb.tsv -d 1 -n."""
    out = tmp_path / "output.tsv"
    r = run_cli(
        ["-c", f"{REF_TEST_DIR}/setb.tsv", "-d", "1", "-n", "-o", str(out)]
    )
    assert r.returncode == 0, r.stderr
    assert out.read_text() == (
        "#cluster_no\tcluster_size\trepertoire_id\tsequence_id\t"
        "duplicate_count\tv_call\tj_call\tjunction\n"
        "1\t2\tB1\tT\t5\tTCRBV07-09\tTCRBJ01-02\t"
        "tgcgcgagcagcctgcgcgtgggcggctatggctataccttt\n"
        "1\t2\tB1\tU\t10\tTCRBV07-09\tTCRBJ01-02\t"
        "tgcgcgagcagcctgcgcgtgggcggctttggctataccttt\n"
        "2\t1\tB2\tV\t7\tTCRBV07-06\tTCRBJ02-01\t"
        "tgcgcgagcagcaccagccatcagcagtatttt\n"
    )
    assert "Clusters:          2" in r.stderr


def test_matrix_self_comparison(tmp_path):
    """Single input file: set 2 aliases set 1 (overlap.cc:799-825)."""
    out = tmp_path / "out.tsv"
    r = run_cli(["-m", f"{REF_TEST_DIR}/setb.tsv", "-o", str(out), "-d", "0"])
    assert r.returncode == 0, r.stderr
    # self-comparison at d=0: diagonal = sum of squared counts per
    # repertoire (B1: 5*5+10*10=125, B2: 7*7=49)
    assert out.read_text() == "#\tB1\tB2\nB1\t125\t0\nB2\t0\t49\n"
    assert "Set 2 is identical to set 1" in r.stderr
