"""The Triton count/extract kernels (ops/gpu_kernels.py) against the
plain XLA reference (engine._count_fn / engine._extract_fn).

On the CPU the kernels run in Pallas interpret mode; the `gpu` cases run
the kernels compiled for the card and skip without one. Around them:
the backend predicate, the wrappers' padding and launch sizes, the
GPU wiring of find_pairs, and the compile cache location."""

import os
import subprocess
import sys

import numpy as np
import pytest

from compairr_tpu.config import Options
from compairr_tpu.core.db import GeneTables
from compairr_tpu.io.airr import read_db
from compairr_tpu.ops import engine, gpu_kernels
from compairr_tpu.ops.engine import MatchSpec
from compairr_tpu.utils.progress import NullLogger

from conftest import REPO
from synth import make_tsv

T = gpu_kernels.TILE

# (differences, indels, exclude_self, ignore_genes, self_compare)
CASES = [
    (0, False, False, False, False),
    (1, False, True, False, False),
    (1, True, False, False, False),
    (1, True, True, True, False),
    (1, True, True, False, True),
    (2, False, False, True, False),
    (2, False, True, False, True),
]
MODES = [
    pytest.param("interpret", id="interpret"),
    pytest.param("gpu", id="gpu", marks=pytest.mark.gpu),
]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A small alphabet and narrow lengths give every kernel class
    plenty of matches."""
    d = tmp_path_factory.mktemp("kernels")
    genes = GeneTables()
    opt = Options()
    out = []
    for name, n, seed in (("a", 300, 31), ("b", 340, 32)):
        path = make_tsv(
            str(d / f"{name}.tsv"), n, 4, seed=seed, n_v=2, n_j=2,
            len_range=(6, 9), alphabet_sub=3, max_count=3,
        )
        out.append(read_db(path, opt, genes, NullLogger(), False, name))
    return out


def _mode(mode, request):
    if mode == "gpu":
        request.getfixturevalue("gpu")
    return mode == "interpret"


def _setup(d1, d2, spec):
    """Kernel inputs (derive), XLA inputs (pack_set) and the classified
    worklist streams of one run."""
    import jax

    from compairr_tpu.ops.derive import device_rows_raw

    by_vjl = not spec.ignore_genes
    indels = spec.indels and spec.differences == 1
    lmax = int(max(d1.longest, d2.longest))

    def side(db):
        order, key, npad = engine.pack_keys(db, T, by_vjl)
        rows = device_rows_raw(db, order, key, npad, lmax, indels)
        p = engine.pack_set(db, lmax, T, by_vjl)
        xla = tuple(
            jax.device_put(x)
            for x in (p.seqs, p.rseqs, p.lengths, p.v, p.j, p.orig)
        )
        return rows, xla, key, npad

    pa, ra, ka, na = side(d1)
    pb, rb, kb, nb = (pa, ra, ka, na) if d2 is d1 else side(d2)
    work = engine.worklist_from_keys(
        ka, d1.n, kb, d2.n, 1 if indels else 0, T, T
    )
    he, hp = engine.classify_worklist(work, ka, d1.n, kb, d2.n, T, T)
    if indels:
        streams = [
            (work[he & ~hp], False, False),
            (work[he & hp], True, False),
            (work[~he & hp], True, True),
        ]
    else:
        streams = [(work[he], False, False)]
    dummy = np.array([na - T, nb - T], np.int32)
    return [s for s in streams if len(s[0])], pa, pb, ra, rb, dummy


def _xla_counts(spec, ra, rb, sw, s_ind, s_io, dummy):
    import jax.numpy as jnp

    wp = gpu_kernels._padded(sw, gpu_kernels.launch_len(len(sw)), dummy)
    fn = engine._count_fn(spec, T, T, indels_ov=s_ind, indel_only=s_io)
    return np.asarray(fn(*ra, *rb, jnp.asarray(wp)))[: len(sw)]


def _kernel_counts(pa, pb, sw, spec, s_ind, s_io, interpret):
    parts = gpu_kernels.count_tiles(
        pa, pb, sw, differences=spec.differences, indels=s_ind,
        indel_only=s_io, exclude_self=spec.exclude_self,
        interpret=interpret,
    )
    return np.concatenate([np.asarray(p) for p in parts])[: len(sw)]


def _spec_dbs(dbs, case):
    d, indels, xself, ig, same = case
    d1, d2 = dbs
    spec = MatchSpec(d, indels, ig, xself)
    return spec, d1, (d1 if same else d2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_count_kernel_matches_xla(dbs, case, mode, request):
    """Per-tile counts equal the XLA scan's, tile by tile, for every
    kernel class (equal-key, mixed, indel-only stream)."""
    interpret = _mode(mode, request)
    spec, d1, d2 = _spec_dbs(dbs, case)
    streams, pa, pb, ra, rb, dummy = _setup(d1, d2, spec)
    total = 0
    for sw, s_ind, s_io in streams:
        ref = _xla_counts(spec, ra, rb, sw, s_ind, s_io, dummy)
        got = _kernel_counts(pa, pb, sw, spec, s_ind, s_io, interpret)
        np.testing.assert_array_equal(got, ref)
        total += int(ref.sum())
    assert total > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_extract_kernel_matches_xla(dbs, case, mode, request):
    """Packed match words equal the XLA extraction record for record,
    on a slab holding matched tiles, empty tiles and dummy tiles."""
    import jax.numpy as jnp

    interpret = _mode(mode, request)
    spec, d1, d2 = _spec_dbs(dbs, case)
    streams, pa, pb, ra, rb, dummy = _setup(d1, d2, spec)
    slab_len, k = 32, 1 << 13
    n_words = 0
    for sw, s_ind, s_io in streams:
        counts = _xla_counts(spec, ra, rb, sw, s_ind, s_io, dummy)
        pick = np.concatenate(
            [np.nonzero(counts)[0][:24], np.nonzero(counts == 0)[0][:4]]
        )
        slab = gpu_kernels._padded(sw[pick], slab_len, dummy)
        ref = engine._extract_fn(
            spec, T, T, slab_len, k, indels_ov=s_ind, indel_only=s_io
        )(*ra, *rb, jnp.asarray(slab))
        got = gpu_kernels.extract_tiles(
            pa, pb, slab, differences=spec.differences, indels=s_ind,
            indel_only=s_io, exclude_self=spec.exclude_self, k=k,
            interpret=interpret,
        )
        n = int(ref[2])
        assert int(got[2]) == n
        np.testing.assert_array_equal(
            np.asarray(got[0])[:n], np.asarray(ref[0])[:n]
        )
        np.testing.assert_array_equal(
            np.asarray(got[1])[:n], np.asarray(ref[1])[:n].astype(np.uint32)
        )
        n_words += n
    assert n_words > 0


@pytest.mark.parametrize("mode", MODES)
def test_count_kernel_order_and_chunking_invariant(dbs, mode, request,
                                                   monkeypatch):
    """Counts follow their tiles through column-major reordering and
    through a worklist split over several launches."""
    interpret = _mode(mode, request)
    spec, d1, d2 = _spec_dbs(dbs, (1, True, False, False, False))
    streams, pa, pb, _ra, _rb, _dummy = _setup(d1, d2, spec)
    sw, s_ind, s_io = streams[1]
    base = _kernel_counts(pa, pb, sw, spec, s_ind, s_io, interpret)
    order = np.lexsort((sw[:, 0], sw[:, 1]))
    np.testing.assert_array_equal(
        _kernel_counts(pa, pb, sw[order], spec, s_ind, s_io, interpret),
        base[order],
    )
    monkeypatch.setattr(gpu_kernels, "CHUNK", 8)
    np.testing.assert_array_equal(
        _kernel_counts(pa, pb, sw, spec, s_ind, s_io, interpret), base
    )


@pytest.mark.parametrize("n,expect", [(0, 8), (1, 8), (8, 8), (9, 16),
                                      (1000, 1024), (1 << 20, 1 << 20)])
def test_launch_len_ladder(n, expect):
    assert gpu_kernels.launch_len(n) == expect


def test_dummy_tiles_count_zero(dbs):
    """Worklist padding aims at the all-padding block, whose rows have
    no bucket: a launch of dummy tiles only counts nothing, even on a
    self-comparison without self-exclusion (pad rows match themselves
    residue for residue)."""
    d1, _ = dbs
    spec = MatchSpec(1, True, False, False)
    _streams, pa, pb, _ra, _rb, dummy = _setup(d1, d1, spec)
    work = np.repeat(dummy[None, :], 5, axis=0)
    for s_ind, s_io in ((False, False), (True, False), (True, True)):
        got = _kernel_counts(pa, pb, work, spec, s_ind, s_io, True)
        np.testing.assert_array_equal(got, np.zeros(5, np.int32))


def test_backend_predicate(monkeypatch):
    """cpu -> the XLA reference, gpu -> the kernels, anything else is
    an error rather than a silent fallback."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert engine.on_gpu() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert engine.on_gpu() is True
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        engine.on_gpu()


def test_tile_route_refuses_unknown_backend(dbs, monkeypatch):
    import jax

    d1, _ = dbs
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "0")
    with pytest.raises(RuntimeError):
        engine.find_pairs(d1, d1, MatchSpec(1, True, False))


@pytest.mark.parametrize(
    "d,indels,same", [(1, True, True), (2, False, False), (1, True, False)]
)
def test_find_pairs_gpu_wiring(dbs, monkeypatch, d, indels, same):
    """The GPU branch of find_pairs (device derive, kernel dispatch
    across devices, word unpacking) run with the kernels in interpret
    mode returns exactly the CPU route's pairs."""
    d1, d2 = dbs
    if same:
        d2 = d1
    spec = MatchSpec(d, indels, False)
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "0")
    i1, i2, dist = engine.find_pairs(d1, d2, spec)
    want = sorted(zip(i1.tolist(), i2.tolist(), dist.tolist()))

    calls = []
    count, extract = gpu_kernels.count_tiles, gpu_kernels.extract_tiles

    def count_i(*a, **k):
        calls.append("count")
        return count(*a, interpret=True, **k)

    def extract_i(*a, **k):
        calls.append("extract")
        return extract(*a, interpret=True, **k)

    monkeypatch.setattr(gpu_kernels, "count_tiles", count_i)
    monkeypatch.setattr(gpu_kernels, "extract_tiles", extract_i)
    monkeypatch.setattr(engine, "on_gpu", lambda: True)
    j1, j2, dist2 = engine.find_pairs(d1, d2, spec)
    assert engine.LAST_ROUTE == "tiles"
    assert "count" in calls and "extract" in calls
    assert sorted(zip(j1.tolist(), j2.tolist(), dist2.tolist())) == want
    assert len(want) > (d1.n if same else 0)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache."""
    import jax

    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        want = str(tmp_path / "c")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    assert engine.compilation_cache_dir() == want
    monkeypatch.delenv("COMPAIRR_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(engine, "_CACHE_ENABLED", False)
    before = jax.config.jax_compilation_cache_dir
    try:
        engine._enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_alone_fails_without_ok(tmp_path):
    """chip_smoke.py without the rest of the repo exits nonzero and
    prints no result line."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_cpu_backend(monkeypatch, capsys):
    """On a CPU-only JAX the smoke's platform gate exits nonzero before
    any phase, with no result line."""
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(1)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
