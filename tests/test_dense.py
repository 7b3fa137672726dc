import numpy as np
import pytest

from compairr_tpu.config import Options
from compairr_tpu.constants import (
    SCORE_JACCARD,
    SCORE_MAX,
    SCORE_MEAN,
    SCORE_MH,
    SCORE_MIN,
    SCORE_PRODUCT,
)
from compairr_tpu.core.db import GeneTables
from compairr_tpu.core.score import pair_scores
from compairr_tpu.io.airr import read_db
from compairr_tpu.ops.engine import MatchSpec, dense_matrix, find_pairs
from compairr_tpu.utils.progress import NullLogger

from synth import make_tsv


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    # small counts keep every dense f32 partial sum exact (< 2^24), so
    # dense and sparse results must agree bit-for-bit
    a_path = make_tsv(
        str(d / "a.tsv"), 400, 5, seed=21, alphabet_sub=5, max_count=3
    )
    b_path = make_tsv(
        str(d / "b.tsv"), 500, 7, seed=22, alphabet_sub=5, max_count=3
    )
    genes = GeneTables()
    opt = Options()
    log = NullLogger()
    d1 = read_db(a_path, opt, genes, log, False, "1")
    d2 = read_db(b_path, opt, genes, log, False, "2")
    return d1, d2


def sparse_matrix(d1, d2, spec, score_int, ignore_counts):
    idx1, idx2, _ = find_pairs(d1, d2, spec)
    m = np.zeros((d1.repertoire_count, d2.repertoire_count))
    s = pair_scores(
        d1.counts[idx1], d2.counts[idx2], score_int, ignore_counts
    )
    np.add.at(m, (d1.rep_no[idx1], d2.rep_no[idx2]), s)
    return m


@pytest.mark.parametrize(
    "d,indels,genes,score,f",
    [
        (0, False, False, SCORE_PRODUCT, False),
        (1, False, False, SCORE_PRODUCT, False),
        (1, True, False, SCORE_PRODUCT, False),
        (2, False, False, SCORE_PRODUCT, False),
        (1, False, True, SCORE_MIN, False),
        (1, False, False, SCORE_MAX, True),
        (2, False, False, SCORE_MEAN, False),
    ],
)
def test_dense_matches_sparse(dbs, d, indels, genes, score, f):
    d1, d2 = dbs
    spec = MatchSpec(differences=d, indels=indels, ignore_genes=genes)
    dm = dense_matrix(d1, d2, spec, score, f)
    sm = sparse_matrix(d1, d2, spec, score, f)
    np.testing.assert_allclose(dm, sm, rtol=0, atol=0)



@pytest.mark.parametrize(
    "score,f",
    [
        (SCORE_PRODUCT, False),
        (SCORE_MH, False),
        (SCORE_MIN, False),
        (SCORE_MAX, False),
        (SCORE_MEAN, False),
        (SCORE_JACCARD, False),
        (SCORE_PRODUCT, True),
    ],
)
def test_dense_integer_scores_match_sparse(dbs, score, f):
    """Every integer score mode through the XLA dense path equals the
    sparse path's float64 accumulation exactly (the f32 exactness
    guard keeps every partial an integer below 2^24)."""
    d1, d2 = dbs
    spec = MatchSpec(differences=1, indels=True, ignore_genes=False)
    dm = dense_matrix(d1, d2, spec, score, f)
    sm = sparse_matrix(d1, d2, spec, score, f)
    np.testing.assert_array_equal(dm, sm)


def test_dense_guard_chunks_match_one_shot(dbs, monkeypatch):
    """A forced chunk plan (tiny f32 budget, host tiles for the
    heaviest) must give the unchunked result exactly."""
    from compairr_tpu.ops import engine

    d1, d2 = dbs
    spec = MatchSpec(differences=2, indels=False, ignore_genes=False)
    whole = dense_matrix(d1, d2, spec, SCORE_PRODUCT, False)
    monkeypatch.setattr(engine, "_F32_EXACT_LIMIT", 40.0)
    chunked = dense_matrix(d1, d2, spec, SCORE_PRODUCT, False)
    np.testing.assert_array_equal(whole, chunked)


def test_dense_self_comparison(dbs):
    d1, _ = dbs
    spec = MatchSpec(differences=1, indels=False, ignore_genes=False)
    dm = dense_matrix(d1, d1, spec, SCORE_PRODUCT, False)
    sm = sparse_matrix(d1, d1, spec, SCORE_PRODUCT, False)
    np.testing.assert_allclose(dm, sm, rtol=0, atol=0)



def _host_layout(p, n, lmax):
    """pack_set arrays as the kernels' position-major device layout."""
    return p.seqs[:n, :lmax].T, p.rseqs[:n, :lmax].T


def test_device_derivations_match_host_pack(dbs):
    """device_rows_raw (the GPU upload path, which sorts, reverses and
    transposes rows on device) must reproduce pack_set's host layouts
    exactly, with padding rows bucketless (grp -1, length 0)."""
    from compairr_tpu.ops.derive import device_rows_raw
    from compairr_tpu.ops.engine import pack_keys, pack_set

    d1, _ = dbs
    lmax = int(d1.longest)
    tile = 128
    p = pack_set(d1, lmax, tile, by_vjl=True)
    order, key, npad = pack_keys(d1, tile, by_vjl=True)
    assert npad == p.np_
    np.testing.assert_array_equal(key, p.key)
    np.testing.assert_array_equal(order, p.orig[: d1.n])

    rows = device_rows_raw(d1, order, key, npad, lmax, indels=True)
    n = d1.n
    seqs_t, rseqs_t = _host_layout(p, n, lmax)
    seqs = np.asarray(rows["seqs"])
    np.testing.assert_array_equal(seqs[:, :n], seqs_t)
    np.testing.assert_array_equal(np.asarray(rows["rseqs"])[:, :n], rseqs_t)
    lens = np.asarray(rows["len"])
    grp = np.asarray(rows["grp"])
    np.testing.assert_array_equal(lens[:n], p.lengths[:n])
    nj = max(len(d1.genes.j_names), 1)
    np.testing.assert_array_equal(grp[:n], p.v[:n] * nj + p.j[:n])
    np.testing.assert_array_equal(np.asarray(rows["orig"])[:n], p.orig[:n])
    # padding rows never match: no bucket, no length, pad residues
    assert (grp[n:] == -1).all() and (lens[n:] == 0).all()
    assert (np.asarray(rows["orig"])[n:] == -1).all()
    assert (seqs[:, n:] == d1.pad_value).all()
    no_indels = device_rows_raw(d1, order, key, npad, lmax, indels=False)
    assert no_indels["rseqs"] is None


def test_chunked_derive_matches_host_pack(dbs, monkeypatch):
    """The fori_loop chunked derive (used above _DERIVE_CHUNK rows to
    bound device temporaries) must produce the same layouts as the
    single-shot branch."""
    import compairr_tpu.ops.derive as D
    from compairr_tpu.ops.engine import pack_keys, pack_set

    d1, _ = dbs
    monkeypatch.setattr(D, "_DERIVE_CHUNK", 64)
    # the derive fn is lru_cached on (pad_val, lmax, indels); force a
    # fresh trace so the patched chunk size takes effect
    D._derive_fn.cache_clear()
    lmax = int(d1.longest)
    p = pack_set(d1, lmax, 128, by_vjl=True)
    order, key, npad = pack_keys(d1, 128, by_vjl=True)
    rows = D.device_rows_raw(d1, order, key, npad, lmax, indels=True)
    n = d1.n
    seqs_t, rseqs_t = _host_layout(p, n, lmax)
    np.testing.assert_array_equal(np.asarray(rows["seqs"])[:, :n], seqs_t)
    np.testing.assert_array_equal(np.asarray(rows["rseqs"])[:, :n], rseqs_t)
    np.testing.assert_array_equal(np.asarray(rows["orig"])[:n], p.orig[:n])
    monkeypatch.undo()
    D._derive_fn.cache_clear()
