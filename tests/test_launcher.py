"""bin/compairr launcher + lazy jax import (utils/lazyjax).

Runs through the launcher must byte-match the module invocation, and
host-only routes must never import jax.
"""

import os
import subprocess
import sys

import numpy as np

from synth import make_tsv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_launcher_matches_module(tmp_path):
    a = make_tsv(str(tmp_path / "a.tsv"), 300, 4, seed=7)
    out1 = tmp_path / "o1.tsv"
    out2 = tmp_path / "o2.tsv"
    r1 = subprocess.run(
        [os.path.join(REPO, "bin", "compairr"), "-z", a,
         "-o", str(out1), "-l", str(tmp_path / "l1.txt")],
        capture_output=True, cwd=str(tmp_path),
    )
    assert r1.returncode == 0, r1.stderr[-800:]
    r2 = subprocess.run(
        [sys.executable, "-m", "compairr_tpu", "-z", a,
         "-o", str(out2), "-l", str(tmp_path / "l2.txt")],
        capture_output=True, cwd=REPO,
    )
    assert r2.returncode == 0, r2.stderr[-800:]
    assert out1.read_bytes() == out2.read_bytes()


def test_launcher_device_route(tmp_path):
    """A run that needs the device engine (d=1 -i) works through the
    launcher (lazy jax import path)."""
    a = make_tsv(str(tmp_path / "a.tsv"), 150, 3, seed=8)
    b = make_tsv(str(tmp_path / "b.tsv"), 150, 3, seed=9)
    out1 = tmp_path / "o1.tsv"
    out2 = tmp_path / "o2.tsv"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for cmd, out in (
        ([os.path.join(REPO, "bin", "compairr")], out1),
        ([sys.executable, "-m", "compairr_tpu"], out2),
    ):
        r = subprocess.run(
            [*cmd, "-m", a, b, "-d", "1", "-i", "-o", str(out),
             "-l", str(tmp_path / "l.txt")],
            capture_output=True, cwd=REPO, env=env,
        )
        assert r.returncode == 0, r.stderr[-800:]
    assert out1.read_bytes() == out2.read_bytes()


def test_host_routes_import_no_jax(tmp_path):
    """The dedup/exact/pigeonhole routes must complete without ever
    importing jax (the launcher's whole point)."""
    a = make_tsv(str(tmp_path / "a.tsv"), 200, 3, seed=10)
    code = (
        "import sys\n"
        "sys.argv = ['compairr', '-z', %r, '-o', %r, '-l', %r]\n"
        "from compairr_tpu.cli import main\n"
        "assert main(sys.argv[1:]) == 0\n"
        "assert 'jax' not in sys.modules, 'host route imported jax'\n"
        % (a, str(tmp_path / "o.tsv"), str(tmp_path / "l.txt"))
    )
    env = {**os.environ,
           "PYTHONPATH": REPO + ":" + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr[-1200:]
