"""Routing-threshold pins.

find_pairs picks between four sparse routes (exact hash join, d=1
variant join, pigeonhole piece grouping, device tile engine) with
measured-once heuristics (engine.variant_join_route, the pigeonhole
candidate budget). All routes are pair-identical (tests/test_oracle.py)
so a flipped threshold is silent — these tests pin which route
representative shapes take via the engine.LAST_ROUTE probe, and the
variant_join_route decision boundaries themselves with shape fakes.
"""

import random
from dataclasses import dataclass

import numpy as np
import pytest

import compairr_tpu.ops.sparse_host as sparse_host
from compairr_tpu.ops import engine
from compairr_tpu.ops.engine import MatchSpec, find_pairs, variant_join_route

from test_oracle import make_db


def _rand_db(n, rng, lo=6, hi=9, alpha=3, nv=2, nj=2):
    seqs = [
        [rng.randrange(alpha) for _ in range(rng.randint(lo, hi))]
        for _ in range(n)
    ]
    vs = [rng.randrange(nv) for _ in seqs]
    js = [rng.randrange(nj) for _ in seqs]
    return make_db(seqs, vs, js)


def test_route_exact_d0():
    rng = random.Random(0)
    db = _rand_db(100, rng)
    find_pairs(db, db, MatchSpec(0, False, False))
    assert engine.LAST_ROUTE == "exact"


def test_route_same_set_d1_pigeonhole():
    rng = random.Random(1)
    db = _rand_db(150, rng)
    find_pairs(db, db, MatchSpec(1, False, False))
    assert engine.LAST_ROUTE == "pigeonhole"


def test_route_asymmetric_two_file_variant_join():
    # existence-style shape: tiny query set vs large subject set where
    # nmin * lmax * alpha < n1 + n2 (variant rows cheaper than extra
    # pigeonhole passes)
    rng = random.Random(2)
    small = _rand_db(5, rng, lo=8, hi=8)
    big = _rand_db(1000, rng, lo=8, hi=8)
    assert variant_join_route(small, big, MatchSpec(1, False, False))
    find_pairs(small, big, MatchSpec(1, False, False))
    assert engine.LAST_ROUTE == "variant_join"


def test_route_indel_default_tiles():
    rng = random.Random(3)
    db = _rand_db(120, rng)
    find_pairs(db, db, MatchSpec(1, True, False))
    assert engine.LAST_ROUTE == "tiles"


def test_route_indel_forced_host(monkeypatch):
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "all")
    rng = random.Random(4)
    db = _rand_db(120, rng)
    find_pairs(db, db, MatchSpec(1, True, False))
    assert engine.LAST_ROUTE == "pigeonhole_indel"


def test_route_budget_overflow_falls_to_tiles(monkeypatch):
    # duplicate-heavy data blows the candidate budget; the pigeonhole
    # must hand the run to the tile engine, with identical pairs
    rng = random.Random(5)
    db = _rand_db(80, rng)
    spec = MatchSpec(1, False, False)
    i1, i2, _ = find_pairs(db, db, spec)
    assert engine.LAST_ROUTE == "pigeonhole"
    monkeypatch.setattr(sparse_host, "PIGEONHOLE_MAX_CANDIDATES", 0)
    j1, j2, _ = find_pairs(db, db, spec)
    assert engine.LAST_ROUTE == "tiles"
    assert set(zip(i1, i2)) == set(zip(j1, j2))


@dataclass
class _Shape:
    """Duck-typed stand-in carrying only what variant_join_route reads."""

    n: int
    longest: int
    nucleotides: bool = False


def test_variant_join_boundaries():
    spec = MatchSpec(1, False, False)
    big = _Shape(n=100_000_000, longest=10)

    # nmin boundary: 2^16 qualifies, 2^16 + 1 does not
    assert variant_join_route(_Shape(1 << 16, 10), big, spec)
    assert not variant_join_route(_Shape((1 << 16) + 1, 10), big, spec)

    # cost boundary: nmin*lmax*alpha < n1+n2 is strict
    # aa alpha=20: nmin=100, lmax=10 -> 20000 variant rows
    small = _Shape(100, 10)
    just_over = _Shape(20_000 - small.n + 1, 10)
    just_under = _Shape(20_000 - small.n, 10)
    assert variant_join_route(small, just_over, spec)
    assert not variant_join_route(small, just_under, spec)

    # nt alphabet shrinks the variant row count 5x
    small_nt = _Shape(100, 10, nucleotides=True)
    mid_nt = _Shape(4_000 - 100 + 1, 10, nucleotides=True)
    assert variant_join_route(small_nt, mid_nt, spec)

    # same-object and wrong-spec guards
    assert not variant_join_route(small, small, spec)
    assert not variant_join_route(small, big, MatchSpec(1, True, False))
    assert not variant_join_route(small, big, MatchSpec(2, False, False))


@pytest.mark.parametrize(
    "n,longest", [(10, 9), (2_000_000, 22), (2_000_001, 22),
                  (30_000_000, 37)]
)
def test_pair_plan_numeric(n, longest):
    """Every size plans the GPU kernel's block as the tile, the exact
    longest sequence as the residue loop bound, and extraction slabs
    of 2^24 match-words."""
    from compairr_tpu.ops import gpu_kernels

    @dataclass
    class Fake:
        n: int
        longest: int
        nucleotides: bool = False

    spec = MatchSpec(1, True, False)
    tile, s_extract, lmax, by_vjl, use_indels = engine._pair_plan(
        Fake(n, longest), Fake(n, longest), spec
    )
    assert (tile, lmax, by_vjl, use_indels) == (
        gpu_kernels.TILE, longest, True, True
    )
    assert s_extract * tile * (tile // 32) == 1 << 24


def test_cli_device_route_device_count_invariant(tmp_path):
    """A device-route indel run through the CLI writes the same matrix
    on one device as split over the 8 virtual devices, and its -l log
    carries no device-timing line (the log format is pinned to the
    reference's)."""
    import os
    import subprocess
    import sys as _sys

    from synth import make_tsv

    tsv = make_tsv(str(tmp_path / "a.tsv"), 400, 3, seed=11)

    def run(devices, tag):
        env = dict(os.environ, COMPAIRR_DEVICES=devices)
        out = tmp_path / f"{tag}.tsv"
        log = tmp_path / f"{tag}.log"
        r = subprocess.run(
            [_sys.executable, "-m", "compairr_tpu", "-m", "-d", "1",
             "-i", tsv, tsv, "-o", str(out), "-l", str(log)],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        return out.read_bytes(), log.read_text()

    m_one, log_one = run("1", "one")
    m_all, log_all = run("0", "all")
    assert m_one == m_all
    assert "Dispatch" not in log_one + log_all


@pytest.mark.parametrize("per_device_min", [1, 8, 10**9])
def test_device_split_threshold(monkeypatch, per_device_min):
    """The minimum tiles per extra device only decides how the
    worklist spreads over devices, never the pairs."""
    rng = random.Random(6)
    db = _rand_db(300, rng)
    spec = MatchSpec(1, True, False)
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "0")
    base = find_pairs(db, db, spec)
    monkeypatch.setattr(engine, "_TILES_PER_DEVICE_MIN", per_device_min)
    got = find_pairs(db, db, spec)
    assert engine.LAST_ROUTE == "tiles"
    assert sorted(zip(*base)) == sorted(zip(*got))
