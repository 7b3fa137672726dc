"""Block-sparse all-vs-all matching engine.

Accelerator formulation of CompAIRR's matching problem. The reference
avoids the all-vs-all grid with Zobrist-hashed variant enumeration
(src/variants.cc, overlap.cc:253-284) — a pointer-chasing design
hostile to accelerators. Here the d>2 fallback (overlap.cc:286-359, an
all-vs-all distance grid) becomes the device algorithm for every d,
made fast by:

  * packing sequences into int8 [N, Lmax] tensors (pad residue matches
    itself so equal-length Hamming distance is Lmax - #position-matches)
  * sorting both sets by length and only visiting tile pairs whose
    length ranges are compatible (equal, or ±1 with indels) — a
    host-built worklist of (row_block, col_block) tiles
  * computing each tile with XLA (this module, the executable
    reference the CPU backend runs) or, on a GPU, the Triton kernels of
    ops/gpu_kernels.py — on_gpu() is the one backend predicate
  * one-indel matching via the prefix+suffix identity: a and b with
    |len(a)-len(b)| == 1 match iff common_prefix(a,b) +
    common_suffix(a,b) >= min(len), equivalent to the reference's
    deletion check (src/variants.cc:197-216)

Two result paths:
  * sparse: matched (i, j, distance) triples — feeds --pairs output,
    clustering, and byte-exact f64 score accumulation on host
  * dense: per-repertoire score matrix accumulated on device — the
    throughput path for huge inputs
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np

# lazy proxies: host-only routes (exact join, pigeonhole, variant
# join) never import jax (utils/lazyjax)
from ..utils.lazyjax import jax, jnp, lax
from ..core.db import SeqDB
from ..utils.progress import Logger
from .sparse_host import (  # noqa: F401  (exact_match_groups re-exported)
    _find_pairs_exact,
    _find_pairs_pigeonhole,
    _find_pairs_pigeonhole_indel,
    _find_pairs_variant_join,
    exact_match_groups,
)

TILE_M = 128
TILE_N = 128

# Route probe: find_pairs records which execution route resolved the
# most recent call ("exact", "variant_join", "pigeonhole",
# "pigeonhole_indel", "tiles"). Diagnostic only — tests/test_routing.py
# pins the routing thresholds with it so a refactor can't silently flip
# a representative workload onto a slower path (the paths themselves
# are pair-identical, asserted in tests/test_oracle.py).
LAST_ROUTE: Optional[str] = None


def _note_route(name: str) -> None:
    global LAST_ROUTE
    LAST_ROUTE = name


class _PhaseTimer:
    """Opt-in coarse phase timing for find_pairs (COMPAIRR_TIMING=1):
    prints cumulative wall per labelled phase to stderr at the end of
    the run. Zero overhead when disabled.

    Device laps measure the async *enqueue* (dispatch), not kernel
    completion — jax returns before the device finishes, so the
    remaining device time surfaces in whichever later phase first
    blocks on the result. To time a kernel itself, block on its
    result (np.asarray or jax.block_until_ready)."""

    def __init__(self) -> None:
        self.enabled = os.environ.get("COMPAIRR_TIMING") == "1"
        self._t = 0.0
        self._acc: dict[str, float] = {}

    def mark(self) -> None:
        if self.enabled:
            import time

            self._t = time.perf_counter()

    def lap(self, label: str) -> None:
        if self.enabled:
            import time

            now = time.perf_counter()
            self._acc[label] = self._acc.get(label, 0.0) + (now - self._t)
            self._t = now

    def report(self, prefix: str) -> None:
        if self.enabled and self._acc:
            import sys

            parts = " ".join(
                f"{k}={v:.2f}s" for k, v in self._acc.items()
            )
            print(f"[timing] {prefix}: {parts}", file=sys.stderr)


_CACHE_ENABLED = False


def compilation_cache_dir() -> str:
    """Where compiled executables persist: JAX_COMPILATION_CACHE_DIR
    when set, else <repo>/.jax_cache (a fixed path, so later runs of
    this checkout hit the entries)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        ),
        ".jax_cache",
    )


def _enable_compilation_cache() -> None:
    """Persist compiled executables across processes. Called from the
    device-path entries, not at import — importing this module must
    stay jax-free for the host-only routes (lazyjax).
    COMPAIRR_NO_COMPILE_CACHE disables it."""
    global _CACHE_ENABLED
    if _CACHE_ENABLED:
        return
    _CACHE_ENABLED = True
    if os.environ.get("COMPAIRR_NO_COMPILE_CACHE"):
        return
    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)


def on_gpu() -> bool:
    """The one backend predicate. True on a CUDA GPU, where the sparse
    engine runs the Triton kernels (ops/gpu_kernels.py); False on the
    CPU, which runs the plain XLA formulation of this module — the
    executable reference the tests hold the kernels to. Any other
    platform is an error: no kernel or layout here was built for it."""
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise RuntimeError(
        f"unsupported JAX backend {backend!r}: compairr_tpu runs on a "
        "CUDA GPU or on the CPU"
    )


@dataclass(frozen=True)
class MatchSpec:
    differences: int
    indels: bool
    ignore_genes: bool
    exclude_self: bool = False  # cluster mode: seed != hit


@dataclass
class PackedSet:
    """A SeqDB sorted by length and padded for tiling."""

    seqs: np.ndarray  # int8 [Np, L] (pad rows appended)
    rseqs: np.ndarray  # int8 [Np, L] per-row reversed sequences
    lengths: np.ndarray  # int32 [Np], padding rows = -1000000
    v: np.ndarray  # int32 [Np]
    j: np.ndarray  # int32 [Np]
    orig: np.ndarray  # int64 [Np] original index, -1 for padding
    rep: np.ndarray  # int32 [Np] repertoire index, -1 for padding
    counts: np.ndarray  # float32 [Np] duplicate counts, 0 for padding
    key: np.ndarray  # int64 [Np] sort key (see pack_set), huge for padding
    n: int  # real sequence count

    @property
    def np_(self) -> int:
        return int(self.seqs.shape[0])


_LEN_PAD = -1000000


def _reverse_rows(seqs: np.ndarray, lengths: np.ndarray, pad: int) -> np.ndarray:
    """Per-row reversal within each row's own length. Grouped by
    length so every group is a plain strided slice copy (2-D gathers
    are far slower in numpy)."""
    n, lmax = seqs.shape
    out = np.full((n, lmax), pad, dtype=np.int8)
    if n == 0:
        return out
    for l in np.unique(lengths):
        if l <= 0:
            continue
        m = lengths == l
        out[m, :l] = seqs[m, l - 1 :: -1]
    return out


_KEY_PAD = np.int64(1) << 62


def pack_set(
    db: SeqDB, lmax: int, tile: int, by_vjl: bool = False,
    need_rseqs: bool = True,
) -> PackedSet:
    """Sort by a bucket key and pad row count to a tile multiple plus
    one all-padding dummy tile (the target of worklist padding).

    by_vjl=False sorts by length alone; by_vjl=True sorts by
    (v_gene, j_gene, length) — the match precondition
    (src/overlap.cc:195-196) — which shrinks the tile worklist by
    orders of magnitude when genes must agree, the grid analogue of
    the reference's variant-hashing pair avoidance. The length occupies
    the low 16 bits of the key so the indel tolerance is a +-1 key
    range within the same gene pair.

    need_rseqs=False skips the host-side per-row reversal (a ~0.3 s/M
    rows memory shuffle) for runs without indels.
    """
    n = db.n
    if by_vjl:
        nj = max(len(db.genes.j_names), 1)
        vj = db.v_no.astype(np.int64) * nj + db.j_no.astype(np.int64)
        key_real = (vj << 16) | db.lengths.astype(np.int64)
    else:
        key_real = db.lengths.astype(np.int64)
    order = np.argsort(key_real, kind="stable")
    npad = canon_rows(n, tile)

    pad_val = db.pad_value
    seqs = np.full((npad, lmax), pad_val, dtype=np.int8)
    if n:
        width = db.seqs.shape[1]
        seqs[:n, :width] = db.seqs[order]
    lengths = np.full(npad, _LEN_PAD, dtype=np.int32)
    lengths[:n] = db.lengths[order]
    v = np.full(npad, -1, dtype=np.int32)
    jj = np.full(npad, -1, dtype=np.int32)
    if n:
        v[:n] = db.v_no[order]
        jj[:n] = db.j_no[order]
    orig = np.full(npad, -1, dtype=np.int64)
    orig[:n] = order
    rep = np.full(npad, -1, dtype=np.int32)
    counts = np.zeros(npad, dtype=np.float32)
    key = np.full(npad, _KEY_PAD, dtype=np.int64)
    if n:
        rep[:n] = db.rep_no[order]
        counts[:n] = db.counts[order].astype(np.float32)
        key[:n] = key_real[order]

    rseqs = np.full((npad, lmax), pad_val, dtype=np.int8)
    if n and need_rseqs:
        rseqs[:n] = _reverse_rows(seqs[:n], lengths[:n], pad_val)

    return PackedSet(
        seqs=seqs,
        rseqs=rseqs,
        lengths=lengths,
        v=v,
        j=jj,
        orig=orig,
        rep=rep,
        counts=counts,
        key=key,
        n=n,
    )


def canon_rows(n: int, tile: int) -> int:
    """Smallest padded row count >= n + tile (one all-pad dummy tile),
    tile-aligned, drawn from a ~1.25x geometric ladder. Shapes under
    jit are compiled per exact size; quantising row counts bounds the
    set of distinct compiles across dataset sizes."""
    need = _round_up(n, tile) + tile
    s = tile
    while s < need:
        s = _round_up(int(s * 1.25) + 1, tile)
    return s


def pack_keys(db: SeqDB, tile: int, by_vjl: bool):
    """Host half of the GPU pack: the bucket sort order and the sorted
    (padded) key vector, leaving all row gathering to the device
    (derive.device_rows_raw). Returns (order int32[n], keys
    int64[npad], npad)."""
    n = db.n
    nj = max(len(db.genes.j_names), 1)
    npad = canon_rows(n, tile)
    if n:
        # native stable counting sort over the tiny (vj, len) bin
        # domain: one count + one scatter pass instead of numpy's
        # int64 key temporaries + radix argsort (~9-16 s of a Keck
        # device-path wall, mostly first-touch page faults)
        from ..io.native import pack_keys_native

        nat = pack_keys_native(db.v_no, db.j_no, db.lengths, nj, by_vjl)
        if nat is not None:
            order, keys_sorted = nat
            key = np.full(npad, _KEY_PAD, dtype=np.int64)
            key[:n] = keys_sorted
            return order, key, npad
    if by_vjl:
        vj = db.v_no.astype(np.int64) * nj + db.j_no.astype(np.int64)
        key_real = (vj << 16) | db.lengths.astype(np.int64)
    else:
        key_real = db.lengths.astype(np.int64)
    # int32 keys sort ~2x faster (radix passes scale with width)
    sort_view = (
        key_real.astype(np.int32)
        if n == 0 or key_real.max() < (1 << 31)
        else key_real
    )
    order = np.argsort(sort_view, kind="stable").astype(np.int32)
    key = np.full(npad, _KEY_PAD, dtype=np.int64)
    if n:
        key[:n] = key_real[order]
    return order, key, npad


def worklist_from_keys(
    keys_a: np.ndarray,
    n_a: int,
    keys_b: np.ndarray,
    n_b: int,
    delta: int,
    tile_m: int,
    tile_n: int,
) -> np.ndarray:
    """Tile worklist from sorted bucket keys: for each aligned row
    block, the compatible columns (keys within the block's key range
    +- the length tolerance) form one contiguous range. Tiles stay
    aligned to the global grid so no pair is ever visited twice."""
    if n_a == 0 or n_b == 0:
        return np.zeros((0, 2), dtype=np.int32)
    kb = keys_b[:n_b]
    row_starts = np.arange(0, n_a, tile_m, dtype=np.int64)
    row_ends = np.minimum(row_starts + tile_m, n_a) - 1
    lo_keys = keys_a[row_starts] - delta
    hi_keys = keys_a[row_ends] + delta
    los = np.searchsorted(kb, lo_keys, side="left")
    his = np.searchsorted(kb, hi_keys, side="right")
    t0 = los // tile_n
    t1 = -(-his // tile_n)  # exclusive end in tile units
    per_row = np.where(his > los, t1 - t0, 0)
    total = int(per_row.sum())
    if total == 0:
        return np.zeros((0, 2), dtype=np.int32)
    out = np.empty((total, 2), dtype=np.int32)
    out[:, 0] = np.repeat(row_starts, per_row).astype(np.int32)
    offs = np.cumsum(per_row) - per_row
    ramp = np.arange(total, dtype=np.int64) - np.repeat(offs, per_row)
    out[:, 1] = ((np.repeat(t0, per_row) + ramp) * tile_n).astype(np.int32)
    return out


def classify_worklist(
    work: np.ndarray,
    keys_a: np.ndarray,
    n_a: int,
    keys_b: np.ndarray,
    n_b: int,
    tile_m: int,
    tile_n: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(has_eq, has_pm) per worklist tile: whether the tile can contain
    a pair with equal bucket keys (Hamming-candidate) / keys differing
    by exactly one (one-indel candidate, len±1 within a (v,j) bucket —
    the key encodes length in its low 16 bits).

    Exact, not conservative: a tile's row block covers a contiguous
    index range of the sorted keys, so the key values present in it are
    precisely the distinct key values within its [lo, hi] key range.
    Class existence therefore reduces to range-restricted membership
    counts over the distinct key values, vectorised with prefix sums.

    Every real match pair has key distance <= 1 (same genes when keyed
    by (v,j); length within one), so a tile with neither class can be
    dropped outright, and single-class tiles run the cheaper kernel
    (Hamming-only skips the prefix/suffix loops; indel-only skips the
    mismatch count)."""
    nt = len(work)
    if nt == 0 or n_a == 0 or n_b == 0:
        z = np.zeros(nt, dtype=bool)
        return z, z
    ua = np.unique(keys_a[:n_a])
    ub = np.unique(keys_b[:n_b])

    def member(vals):
        idx = np.searchsorted(ub, vals)
        idx = np.minimum(idx, len(ub) - 1)
        return ub[idx] == vals

    def prefix(flags):
        p = np.zeros(len(ua) + 1, dtype=np.int64)
        np.cumsum(flags, out=p[1:])
        return p

    p_eq = prefix(member(ua))
    p_up = prefix(member(ua + 1))
    p_dn = prefix(member(ua - 1))

    r0 = work[:, 0].astype(np.int64)
    c0 = work[:, 1].astype(np.int64)
    ka_lo = keys_a[r0]
    ka_hi = keys_a[np.minimum(r0 + tile_m, n_a) - 1]
    kb_lo = keys_b[np.minimum(c0, n_b - 1)]
    kb_hi = keys_b[np.minimum(c0 + tile_n, n_b) - 1]

    def any_in(p, lo, hi):
        i0 = np.searchsorted(ua, lo, side="left")
        i1 = np.searchsorted(ua, hi, side="right")
        return p[np.maximum(i1, i0)] - p[i0] > 0

    has_eq = any_in(
        p_eq, np.maximum(ka_lo, kb_lo), np.minimum(ka_hi, kb_hi)
    )
    # an up-pair needs a key u in the a-block with u+1 both present in
    # set b and inside the b-block's key range (u in [kb_lo-1, kb_hi-1])
    has_pm = any_in(
        p_up, np.maximum(ka_lo, kb_lo - 1), np.minimum(ka_hi, kb_hi - 1)
    ) | any_in(
        p_dn, np.maximum(ka_lo, kb_lo + 1), np.minimum(ka_hi, kb_hi + 1)
    )
    return has_eq, has_pm


def build_worklist(
    a: PackedSet, b: PackedSet, spec: MatchSpec, tile_m: int, tile_n: int
) -> np.ndarray:
    delta = 1 if (spec.indels and spec.differences == 1) else 0
    return worklist_from_keys(
        a.key, a.n, b.key, b.n, delta, tile_m, tile_n
    )


def order_colmajor(work: np.ndarray) -> np.ndarray:
    """Column-major worklist order (b-block, then a-block): programs
    launched together share the b-block, which then stays in the GPU's
    L2 cache. Result-invariant: the sparse pair set is
    order-independent (consumers re-sort canonically)."""
    if len(work) == 0:
        return work
    return work[np.lexsort((work[:, 0], work[:, 1]))]


def pad_worklist_n(
    work: np.ndarray, npad_a: int, npad_b: int, tile_m: int, tile_n: int
) -> np.ndarray:
    """Pad the worklist to the next power of two (at least 8) with
    dummy tiles aimed at the all-padding rows (zero contribution), so
    compilations are reused across dataset sizes."""
    w = len(work)
    target = max(8, 1 << (w - 1).bit_length()) if w else 8
    if w == target:
        return work
    dummy = np.array(
        [[npad_a - tile_m, npad_b - tile_n]], dtype=np.int32
    )
    return np.concatenate([work, np.repeat(dummy, target - w, axis=0)])


# --------------------------------------------------------------------
# XLA tile computation: the CPU path, the dense path on every backend,
# and the reference the GPU kernels are held to
# --------------------------------------------------------------------


def _tile_codes(
    a_seq,
    a_rseq,
    a_len,
    a_v,
    a_j,
    a_orig,
    b_seq,
    b_rseq,
    b_len,
    b_v,
    b_j,
    b_orig,
    *,
    differences: int,
    indels: bool,
    ignore_genes: bool,
    exclude_self: bool,
    indel_only: bool = False,
):
    """Distance codes for one [TM, TN] tile: 0 = no match, else
    distance + 1. Pure jnp; shapes are static. The mask/distance
    computation is _tile_match; this adds the exclude_self refinement
    (cluster mode, src/cluster.cc:105)."""
    match, dist = _tile_match(
        a_seq, a_rseq, a_len, a_v, a_j,
        b_seq, b_rseq, b_len, b_v, b_j,
        differences=differences, indels=indels,
        ignore_genes=ignore_genes, indel_only=indel_only,
    )
    if exclude_self:
        match = match & (a_orig[:, None] != b_orig[None, :])
    return jnp.where(match, dist + 1, 0).astype(jnp.int8)


def _tile_match(
    a_seq,
    a_rseq,
    a_len,
    a_v,
    a_j,
    b_seq,
    b_rseq,
    b_len,
    b_v,
    b_j,
    *,
    differences: int,
    indels: bool,
    ignore_genes: bool,
    indel_only: bool = False,
):
    """Boolean match mask for one tile. Pad residues match themselves,
    so for equal-length pairs the mismatch count over the padded width
    is the Hamming distance. indel_only skips the Hamming work on tiles
    classify_worklist proved hold no equal-key pair."""
    if indel_only:
        assert indels, "indel_only tiles only exist on indel runs"
        mism = jnp.zeros(
            (a_seq.shape[0], b_seq.shape[0]), dtype=jnp.int32
        )
    else:
        # elementwise compare: on an H100 the XLA dense scan ran faster
        # this way than through a one-hot int8 matmul
        mism = jnp.sum(
            a_seq[:, None, :] != b_seq[None, :, :], axis=2, dtype=jnp.int32
        )
    len_eq = a_len[:, None] == b_len[None, :]
    valid = (a_len[:, None] > 0) & (b_len[None, :] > 0)
    if indel_only:
        # no equal-key pair exists in the tile, so no equal-length pair
        # can match (same genes + equal length would be an equal key)
        match = jnp.zeros_like(len_eq)
    else:
        match = len_eq & (mism <= differences)
    dist = mism

    if indels:
        pref_eq = (a_seq[:, None, :] == b_seq[None, :, :]).astype(jnp.int32)
        pref = jnp.sum(jnp.cumprod(pref_eq, axis=2), axis=2, dtype=jnp.int32)
        suf_eq = (a_rseq[:, None, :] == b_rseq[None, :, :]).astype(jnp.int32)
        suf = jnp.sum(jnp.cumprod(suf_eq, axis=2), axis=2, dtype=jnp.int32)
        minlen = jnp.minimum(a_len[:, None], b_len[None, :])
        len_pm1 = jnp.abs(a_len[:, None] - b_len[None, :]) == 1
        match = match | (len_pm1 & (pref + suf >= minlen))
        dist = jnp.where(len_pm1, 1, dist)

    if not ignore_genes:
        match = match & (a_v[:, None] == b_v[None, :]) & (
            a_j[:, None] == b_j[None, :]
        )
    return match & valid, dist


def pair_score_tile(ca, cb, score_int: int, ignore_counts: bool):
    """Per-pair score g(count_a, count_b) on a tile
    (compute_score, src/overlap.cc:144-166)."""
    from ..constants import (
        SCORE_JACCARD,
        SCORE_MAX,
        SCORE_MH,
        SCORE_MIN,
        SCORE_PRODUCT,
        SCORE_RATIO,
    )

    if ignore_counts:
        return jnp.ones((ca.shape[0], cb.shape[0]), dtype=jnp.float32)
    a = ca[:, None]
    b = cb[None, :]
    if score_int in (SCORE_MH, SCORE_PRODUCT):
        return a * b
    if score_int == SCORE_RATIO:
        return a / jnp.where(b == 0, 1.0, b)
    if score_int in (SCORE_JACCARD, SCORE_MIN):
        return jnp.minimum(a, b) + jnp.zeros_like(a + b)
    if score_int == SCORE_MAX:
        return jnp.maximum(a, b) + jnp.zeros_like(a + b)
    return (a + b) / 2


def dense_tile_contrib(
    a_args, b_args, ra, rb, *, spec_kw, score_int, ignore_counts,
    r1p, r2p, tile_m, tile_n,
):
    """One worklist tile's [R1p, R2p] score contribution (device code,
    usable under jit and shard_map alike)."""
    (a_seq, a_rseq, a_len, a_v, a_j, a_rep, a_cnt) = a_args
    (b_seq, b_rseq, b_len, b_v, b_j, b_rep, b_cnt) = b_args
    sl_a = lambda x: lax.dynamic_slice_in_dim(x, ra, tile_m, axis=0)
    sl_b = lambda x: lax.dynamic_slice_in_dim(x, rb, tile_n, axis=0)
    match, _ = _tile_match(
        sl_a(a_seq), sl_a(a_rseq), sl_a(a_len), sl_a(a_v), sl_a(a_j),
        sl_b(b_seq), sl_b(b_rseq), sl_b(b_len), sl_b(b_v), sl_b(b_j),
        **spec_kw,
    )
    g = pair_score_tile(sl_a(a_cnt), sl_b(b_cnt), score_int, ignore_counts)
    sc = jnp.where(match, g, 0.0)
    ia = sl_a(a_rep)
    ib = sl_b(b_rep)
    oh1 = (
        ia[:, None] == lax.broadcasted_iota(jnp.int32, (1, r1p), 1)
    ).astype(jnp.float32)
    oh2 = (
        ib[:, None] == lax.broadcasted_iota(jnp.int32, (1, r2p), 1)
    ).astype(jnp.float32)
    # Precision.HIGHEST: at default precision a GPU may run f32
    # matmuls in TF32 (10-bit mantissa), rounding count products (up to
    # 2^24) — full f32 keeps the score reduction integer-exact.
    part = lax.dot_general(
        oh1, sc, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    return lax.dot_general(
        part, oh2, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# --------------------------------------------------------------------
# f32 exactness guard for the dense paths
#
# The dense accumulators are float32 on device: integer-valued scores
# sum exactly only while every intermediate stays below 2^24. The
# guard bounds each worklist tile's possible contribution to any one
# [r1, r2] cell using per-row-block, per-repertoire count statistics,
# splits the worklist into chunks whose partial matrices provably stay
# exact, and sums the partials in float64 on host. Tiles whose OWN
# bound crosses the limit (same-repertoire duplicate blocks with large
# counts) are computed exactly on host instead. Non-integer score
# modes (ratio) are inherently inexact in f32 and skip the guard.
# --------------------------------------------------------------------

_F32_EXACT_LIMIT = float(1 << 24)


def _block_rep_stats(
    rep_sorted: np.ndarray,
    cnt_sorted: np.ndarray,
    n: int,
    tile: int,
    nblocks_pad: int,
    nrep: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per row-block maxima over repertoires of (row count, duplicate
    count sum), on the packed (sorted) row order. A tile (rb, cb)'s
    contribution to any single matrix cell is bounded by products of
    these (see _plan_exact_chunks)."""
    m = np.zeros(nblocks_pad, dtype=np.float64)
    s = np.zeros(nblocks_pad, dtype=np.float64)
    if n == 0:
        return m, s
    blk = np.arange(n, dtype=np.int64) // tile
    idx = blk * nrep + rep_sorted[:n].astype(np.int64)
    size = (int(blk[-1]) + 1) * nrep
    cm = np.bincount(idx, minlength=size).astype(np.float64)
    cs = np.bincount(
        idx, weights=cnt_sorted[:n].astype(np.float64), minlength=size
    )
    cm = cm.reshape(-1, nrep)
    cs = cs.reshape(-1, nrep)
    m[: cm.shape[0]] = cm.max(axis=1)
    s[: cs.shape[0]] = cs.max(axis=1)
    return m, s


def _tile_exact_bounds(
    work: np.ndarray,
    stats_a: tuple[np.ndarray, np.ndarray],
    stats_b: tuple[np.ndarray, np.ndarray],
    tile_m: int,
    tile_n: int,
    score_int: int,
    ignore_counts: bool,
) -> Optional[np.ndarray]:
    """Per-tile upper bound on any single matrix cell's f32
    contribution (see _plan_exact_chunks); None for score modes whose
    values are inherently non-integer (ratio)."""
    from ..constants import SCORE_MH, SCORE_PRODUCT, SCORE_RATIO

    ma, sa = stats_a
    mb, sb = stats_b
    rb = work[:, 0] // tile_m
    cb = work[:, 1] // tile_n
    if ignore_counts:
        return ma[rb] * mb[cb]
    if score_int in (SCORE_PRODUCT, SCORE_MH):
        return sa[rb] * sb[cb]
    if score_int == SCORE_RATIO:
        return None
    return sa[rb] * mb[cb] + sb[cb] * ma[rb]


def _plan_exact_chunks(
    work: np.ndarray,
    stats_a: tuple[np.ndarray, np.ndarray],
    stats_b: tuple[np.ndarray, np.ndarray],
    tile_m: int,
    tile_n: int,
    score_int: int,
    ignore_counts: bool,
):
    """Chunk plan keeping every f32 partial matrix exactly integer (or
    half-integer for mean): returns None when the whole worklist is
    provably safe in one accumulation (or the score mode is inherently
    inexact), else (chunks, host_tiles).

    Soundness: for a tile with row block rb / col block cb, its
    contribution to cell (r1, r2) is sum over matched pairs of
    g(ca, cb). With per-block per-rep maxima M (row count) and S
    (count sum):
      * product/MH: sum <= S_a[rb] * S_b[cb]
      * min/max/mean/ignore-less modes: g <= ca + cb, so
        sum <= S_a[rb]*M_b[cb] + S_b[cb]*M_a[rb]
      * ignore_counts: g = 1, sum <= M_a[rb] * M_b[cb]
    The same quantities bound every intermediate matmul entry (the
    [r1p, TN] partial sums), so a chunk whose tile bounds sum below
    2^24 accumulates exactly in f32."""
    bound = _tile_exact_bounds(
        work, stats_a, stats_b, tile_m, tile_n, score_int, ignore_counts
    )
    if bound is None:
        return None  # non-integer scores: no exactness to preserve
    if float(bound.sum()) < _F32_EXACT_LIMIT:
        return None
    host = bound >= _F32_EXACT_LIMIT
    host_tiles = work[host]
    rest = work[~host]
    csum = np.cumsum(bound[~host])
    chunks = []
    start = 0
    base = 0.0
    while start < len(rest):
        end = int(
            np.searchsorted(csum, base + _F32_EXACT_LIMIT, side="left")
        )
        end = max(end, start + 1)
        chunks.append(rest[start:end])
        base = float(csum[end - 1])
        start = end
    return chunks, host_tiles


def _score_np(ca, cb, score_int: int, ignore_counts: bool):
    """compute_score on host in float64 (reference semantics,
    src/overlap.cc:144-166); ca [M, 1], cb [1, N]."""
    from ..constants import (
        SCORE_JACCARD,
        SCORE_MAX,
        SCORE_MH,
        SCORE_MIN,
        SCORE_PRODUCT,
        SCORE_RATIO,
    )

    if ignore_counts:
        return np.ones((ca.shape[0], cb.shape[1]), dtype=np.float64)
    if score_int in (SCORE_MH, SCORE_PRODUCT):
        return ca * cb
    if score_int == SCORE_RATIO:
        return ca / np.where(cb == 0, 1.0, cb)
    if score_int in (SCORE_JACCARD, SCORE_MIN):
        return np.minimum(ca + np.zeros_like(cb), cb)
    if score_int == SCORE_MAX:
        return np.maximum(ca + np.zeros_like(cb), cb)
    return (ca + cb) / 2.0


def _host_tiles_matrix(
    db1: SeqDB,
    db2: SeqDB,
    orig_a: np.ndarray,
    orig_b: np.ndarray,
    tiles: np.ndarray,
    spec: MatchSpec,
    score_int: int,
    ignore_counts: bool,
    r1p: int,
    r2p: int,
    tile_m: int,
    tile_n: int,
) -> np.ndarray:
    """Exact float64 accumulation of a few worklist tiles on host —
    the fallback for tiles whose f32 bound cannot be met by chunking
    (duplicate-heavy same-repertoire blocks). Match semantics mirror
    _tile_match exactly."""
    out = np.zeros((r1p, r2p), dtype=np.float64)
    w = max(db1.seqs.shape[1], db2.seqs.shape[1], 1)
    pad = db1.pad_value
    use_indels = spec.indels and spec.differences == 1
    for ra, cb0 in tiles:
        ia = orig_a[ra : ra + tile_m]
        ia = ia[ia >= 0]
        ib = orig_b[cb0 : cb0 + tile_n]
        ib = ib[ib >= 0]
        if len(ia) == 0 or len(ib) == 0:
            continue
        la = db1.lengths[ia].astype(np.int64)
        lb = db2.lengths[ib].astype(np.int64)
        A = np.full((len(ia), w), pad, dtype=np.int8)
        A[:, : db1.seqs.shape[1]] = db1.seqs[ia]
        B = np.full((len(ib), w), pad, dtype=np.int8)
        B[:, : db2.seqs.shape[1]] = db2.seqs[ib]
        eq = A[:, None, :] == B[None, :, :]
        mism = w - eq.sum(axis=2)
        match = (la[:, None] == lb[None, :]) & (
            mism <= spec.differences
        )
        if use_indels:
            pref = np.cumprod(eq, axis=2).sum(axis=2)
            Ar = _reverse_rows(A, la.astype(np.int32), pad)
            Br = _reverse_rows(B, lb.astype(np.int32), pad)
            seq = Ar[:, None, :] == Br[None, :, :]
            suf = np.cumprod(seq, axis=2).sum(axis=2)
            pm1 = np.abs(la[:, None] - lb[None, :]) == 1
            minlen = np.minimum(la[:, None], lb[None, :])
            match = match | (pm1 & (pref + suf >= minlen))
        if not spec.ignore_genes:
            match = match & (
                db1.v_no[ia][:, None] == db2.v_no[ib][None, :]
            ) & (db1.j_no[ia][:, None] == db2.j_no[ib][None, :])
        if spec.exclude_self:
            match = match & (ia[:, None] != ib[None, :])
        g = _score_np(
            db1.counts[ia].astype(np.float64)[:, None],
            db2.counts[ib].astype(np.float64)[None, :],
            score_int,
            ignore_counts,
        )
        sel = np.nonzero(match)
        if len(sel[0]):
            np.add.at(
                out,
                (db1.rep_no[ia][sel[0]], db2.rep_no[ib][sel[1]]),
                g[sel],
            )
    return out


def _sparse_devices() -> list:
    """Device set for the sparse tile engine: all local devices by
    default, capped by COMPAIRR_DEVICES. Multi-device runs split the
    tile worklist across devices (each holding a replica of both
    packed sets) — the device equivalent of the reference's pthread
    seed chunking (src/overlap.cc:421-434). The merged pair list is
    identical for any device count, so every consumer (pairs files,
    clustering, byte-exact scoring) stays bit-reproducible."""
    devs = jax.devices()
    try:
        cap = int(os.environ.get("COMPAIRR_DEVICES", "0"))
    except ValueError:
        cap = 0
    if cap <= 0:
        cap = len(devs)
    return devs[: max(1, min(cap, len(devs)))]


# Minimum worklist tiles per extra device: a split replicates both
# packed sets onto every device, which a tiny worklist does not repay.
_TILES_PER_DEVICE_MIN = 8


def _put_tree(x, device, memo=None):
    """Replicate a nest of device arrays onto `device`, preserving
    aliasing (shared leaves are copied once per device)."""
    if memo is None:
        memo = {}
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _put_tree(v, device, memo) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_put_tree(v, device, memo) for v in x)
    key = id(x)
    if key not in memo:
        memo[key] = jax.device_put(x, device)
    return memo[key]


@lru_cache(maxsize=None)
def _dense_fn(
    spec: MatchSpec, score_int: int, ignore_counts: bool,
    tile_m: int, tile_n: int, r1p: int, r2p: int,
):
    spec_kw = dict(
        differences=spec.differences,
        indels=spec.indels and spec.differences == 1,
        ignore_genes=spec.ignore_genes,
    )

    def run(a_args, b_args, starts):
        def step(acc, st):
            contrib = dense_tile_contrib(
                a_args, b_args, st[0], st[1],
                spec_kw=spec_kw, score_int=score_int,
                ignore_counts=ignore_counts, r1p=r1p, r2p=r2p,
                tile_m=tile_m, tile_n=tile_n,
            )
            return acc + contrib, None

        acc0 = jnp.zeros((r1p, r2p), dtype=jnp.float32)
        acc, _ = lax.scan(step, acc0, (starts[:, 0], starts[:, 1]))
        return acc

    return jax.jit(run)


def _device_args(p: PackedSet):
    dev = jax.device_put
    return (
        dev(p.seqs), dev(p.rseqs), dev(p.lengths), dev(p.v), dev(p.j),
        dev(p.rep), dev(p.counts),
    )


def dense_matrix(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    score_int: int,
    ignore_counts: bool,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
    tile_m: int = TILE_M,
    tile_n: int = TILE_N,
) -> np.ndarray:
    """Dense path: accumulate the [R1, R2] overlap matrix on device, as
    one XLA scan over the tile worklist (_dense_fn) on every backend.

    Float32 accumulation on device, guarded for exactness: per-cell
    partial sums of the integer score modes are kept below 2^24 by
    chunking the worklist (partials summed in float64 on host) and
    routing pathological tiles to an exact host path — see
    _plan_exact_chunks. COMPAIRR_DENSE_EXACT=0 disables the guard for
    raw-throughput measurement. The sparse path (find_pairs + host
    f64) remains the byte-exact reference path; this one is for bulk
    throughput.
    """
    if spec.exclude_self:
        # the dense path does not implement self-exclusion (only the
        # sparse extraction carries per-row original indices); a mixed
        # device/host-tile run would silently disagree with itself
        raise ValueError(
            "dense_matrix does not support exclude_self specs; use "
            "find_pairs (the sparse engine) for cluster-style matching"
        )
    _enable_compilation_cache()
    guard = os.environ.get("COMPAIRR_DENSE_EXACT", "1") != "0"
    lmax = int(max(db1.longest, db2.longest, 1))
    by_vjl = not spec.ignore_genes
    r1p = _round_up(max(db1.repertoire_count, 1), 8)
    r2p = _round_up(max(db2.repertoire_count, 1), 128)
    use_indels = spec.indels and spec.differences == 1

    a = pack_set(db1, lmax, tile_m, by_vjl, need_rseqs=use_indels)
    b = (
        a
        if (db2 is db1 and tile_m == tile_n)
        else pack_set(db2, lmax, tile_n, by_vjl, need_rseqs=use_indels)
    )
    work = build_worklist(a, b, spec, tile_m, tile_n)

    if logger is not None and progress_prompt is not None:
        logger.progress_init(progress_prompt, max(len(work), 1))

    fn = _dense_fn(
        spec, score_int, ignore_counts, tile_m, tile_n, r1p, r2p,
    )
    a_dev = _device_args(a)
    b_dev = a_dev if b is a else _device_args(b)

    def dispatch(cw):
        # pad to the pow2 ladder (dummy tiles aim at all-pad rows, zero
        # contribution) so chunk count, not chunk length, bounds the set
        # of compiled shapes
        cw = pad_worklist_n(cw, a.np_, b.np_, tile_m, tile_n)
        return np.asarray(fn(a_dev, b_dev, jnp.asarray(cw))).astype(
            np.float64
        )

    plan = (
        _plan_exact_chunks(
            work,
            _block_rep_stats(
                a.rep, a.counts, a.n, tile_m, a.np_ // tile_m,
                max(db1.repertoire_count, 1),
            ),
            _block_rep_stats(
                b.rep, b.counts, b.n, tile_n, b.np_ // tile_n,
                max(db2.repertoire_count, 1),
            ),
            tile_m, tile_n, score_int, ignore_counts,
        )
        if guard and len(work)
        else None
    )
    if len(work) == 0:
        acc = np.zeros((r1p, r2p), dtype=np.float64)
    elif plan is None:
        acc = dispatch(work)
    else:
        chunks, host_tiles = plan
        acc = np.zeros((r1p, r2p), dtype=np.float64)
        for cw in chunks:
            acc += dispatch(cw)
        if len(host_tiles):
            acc += _host_tiles_matrix(
                db1, db2, a.orig, b.orig, host_tiles, spec,
                score_int, ignore_counts, r1p, r2p, tile_m, tile_n,
            )

    if logger is not None and progress_prompt is not None:
        logger.progress_update(len(work))
        logger.progress_done()

    return acc[: db1.repertoire_count, : db2.repertoire_count]


@lru_cache(maxsize=None)
def _count_fn(spec: MatchSpec, tile_m: int, tile_n: int,
              indels_ov: Optional[bool] = None,
              indel_only: bool = False):
    """Per-tile match counts over the whole worklist in one dispatch —
    phase 1 of sparse extraction (the plain XLA form of
    gpu_kernels.count_tiles). Only tiles with matches are then
    materialised and transferred (phase 2). indels_ov/indel_only
    override the spec-derived kernel class for classified worklist
    streams (classify_worklist)."""
    kw = dict(
        differences=spec.differences,
        indels=(
            spec.indels and spec.differences == 1
            if indels_ov is None
            else indels_ov
        ),
        ignore_genes=spec.ignore_genes,
        exclude_self=spec.exclude_self,
        indel_only=indel_only,
    )

    def run(a_seq, a_rseq, a_len, a_v, a_j, a_orig,
            b_seq, b_rseq, b_len, b_v, b_j, b_orig, starts):
        def one(_, st):
            ra, rb = st[0], st[1]
            sl_a = lambda x: lax.dynamic_slice_in_dim(x, ra, tile_m, axis=0)
            sl_b = lambda x: lax.dynamic_slice_in_dim(x, rb, tile_n, axis=0)
            codes = _tile_codes(
                sl_a(a_seq), sl_a(a_rseq), sl_a(a_len), sl_a(a_v),
                sl_a(a_j), sl_a(a_orig),
                sl_b(b_seq), sl_b(b_rseq), sl_b(b_len), sl_b(b_v),
                sl_b(b_j), sl_b(b_orig),
                **kw,
            )
            return None, jnp.sum((codes != 0).astype(jnp.int32))

        _, counts = lax.scan(one, None, (starts[:, 0], starts[:, 1]))
        return counts

    return jax.jit(run)


K_EXTRACT = 1 << 15  # match-word capacity per extraction dispatch
K_EXTRACT_BIG = 1 << 18  # capacity for match-dense workloads


@lru_cache(maxsize=None)
def _extract_fn(spec: MatchSpec, tile_m: int, tile_n: int, slab: int,
                k: int,
                indels_ov: Optional[bool] = None,
                indel_only: bool = False):
    """Phase-2 sparse extraction with on-device compaction (the plain
    XLA form of gpu_kernels.extract_tiles): compute the match masks for
    `slab` tiles, pack each tile row's lanes into uint32 bit-words (32
    columns per word), and emit only the nonzero (word_index,
    word_bits) records into a fixed [k] buffer. Bit packing shrinks the
    nonzero-compaction input 32x, and the download is O(matched words),
    not O(slab*tile_m*tile_n). Distances are recomputed on host from
    the original sequences (engine._pair_distances)."""
    kw = dict(
        differences=spec.differences,
        indels=(
            spec.indels and spec.differences == 1
            if indels_ov is None
            else indels_ov
        ),
        ignore_genes=spec.ignore_genes,
        exclude_self=spec.exclude_self,
        indel_only=indel_only,
    )

    def run(a_seq, a_rseq, a_len, a_v, a_j, a_orig,
            b_seq, b_rseq, b_len, b_v, b_j, b_orig, starts):
        def one(_, st):
            ra, rb = st[0], st[1]
            sl_a = lambda x: lax.dynamic_slice_in_dim(x, ra, tile_m, axis=0)
            sl_b = lambda x: lax.dynamic_slice_in_dim(x, rb, tile_n, axis=0)
            codes = _tile_codes(
                sl_a(a_seq), sl_a(a_rseq), sl_a(a_len), sl_a(a_v),
                sl_a(a_j), sl_a(a_orig),
                sl_b(b_seq), sl_b(b_rseq), sl_b(b_len), sl_b(b_v),
                sl_b(b_j), sl_b(b_orig),
                **kw,
            )
            m = (codes != 0).reshape(tile_m, tile_n // 32, 32)
            shifts = jnp.arange(32, dtype=jnp.uint32).reshape(1, 1, 32)
            words = jnp.sum(
                m.astype(jnp.uint32) << shifts, axis=-1, dtype=jnp.uint32
            )
            return None, words

        _, words = lax.scan(one, None, (starts[:, 0], starts[:, 1]))
        flat = words.reshape(-1)
        count = jnp.sum((flat != 0).astype(jnp.int32))
        (idx,) = jnp.nonzero(flat, size=k, fill_value=0)
        vals = jnp.take(flat, idx)
        return idx.astype(jnp.int32), vals, count

    return jax.jit(run)


def _pair_distances(
    db1: SeqDB, db2: SeqDB, i1: np.ndarray, i2: np.ndarray
) -> np.ndarray:
    """Distances for matched pairs, recomputed on host: Hamming for
    equal lengths (pad residues match themselves), 1 for one-indel
    matches (lengths differ by one). Chunked to bound memory."""
    n = len(i1)
    dist = np.ones(n, dtype=np.int64)
    if n == 0:
        return dist
    w = min(db1.seqs.shape[1], db2.seqs.shape[1])
    l1 = db1.lengths[i1]
    l2 = db2.lengths[i2]
    eq = np.nonzero(l1 == l2)[0]
    for s0 in range(0, len(eq), 1 << 20):
        sel = eq[s0 : s0 + (1 << 20)]
        a = db1.seqs[i1[sel], :w]
        b = db2.seqs[i2[sel], :w]
        dist[sel] = (a != b).sum(axis=1)
    return dist


def _sparse_inputs(db: SeqDB, tile: int, by_vjl: bool, lmax: int,
                   gpu: bool, indels: bool = True):
    """Device inputs + host metadata for the sparse path. On a GPU the
    packed residues are uploaded and rows are gathered, reversed and
    laid out for the kernels on device (derive.device_rows_raw); on the
    CPU the host-packed arrays feed the XLA formulation. Returns
    (inputs, orig, key, npad): inputs is the kernels' dict on a GPU,
    else the tuple of XLA operands."""
    if gpu:
        from .derive import device_rows_raw

        tm = _PhaseTimer()
        tm.mark()
        order, key, npad = pack_keys(db, tile, by_vjl)
        tm.lap("pack_keys")
        rows = device_rows_raw(db, order, key, npad, lmax, indels)
        tm.lap("rows_raw_enqueue")
        orig = np.full(npad, -1, dtype=np.int64)
        orig[: db.n] = order
        tm.report(f"_sparse_inputs n={db.n}")
        return rows, orig, key, npad
    p = pack_set(db, lmax, tile, by_vjl, need_rseqs=indels)
    dev = jax.device_put
    args = (dev(p.seqs), dev(p.rseqs), dev(p.lengths), dev(p.v),
            dev(p.j), dev(p.orig))
    return args, p.orig, p.key, p.np_


def _pair_plan(db1: SeqDB, db2: SeqDB, spec: MatchSpec):
    """Static launch parameters for a find_pairs run (shared with the
    prefetch path so cache keys always agree): the tile is the GPU
    kernel's block (gpu_kernels.TILE), lmax the longest sequence, and
    extraction slabs hold a constant 16M match-words (67 MB of device
    words) per dispatch."""
    lmax = int(max(db1.longest, db2.longest, 1))
    by_vjl = not spec.ignore_genes
    use_indels = spec.indels and spec.differences == 1
    tile = TILE_M
    s_extract = max(64, (1 << 24) // (tile * (tile // 32)))
    return tile, s_extract, lmax, by_vjl, use_indels


# prefetched device inputs: key -> (db, thread, holder). The db
# reference is stored strong and identity-checked on hit so a recycled
# id() can never serve a stale set's device buffers; every prefetch
# clears the cache first so abandoned entries (exception between
# prefetch and find_pairs) don't pin device HBM past the next run.
_SPARSE_PREFETCH: dict = {}

# full-result prefetch for the tile-engine route (indel runs): the
# whole find_pairs call runs on the worker, so the device count/extract
# phases genuinely overlap the host duplicate-check phase.
# key -> (db1, db2, thread, holder)
_RESULT_PREFETCH: dict = {}


def _sparse_inputs_cached(db, tile, by_vjl, lmax, gpu, indels):
    key = (id(db), tile, by_vjl, lmax, gpu, indels)
    hit = _SPARSE_PREFETCH.pop(key, None)
    if hit is not None and hit[0] is db:
        _db, thread, holder = hit
        thread.join()
        if holder[0] is not None:
            return holder[0]
    return _sparse_inputs(db, tile, by_vjl, lmax, gpu, indels)


def prefetch_find_pairs(db1: SeqDB, db2: SeqDB, spec: MatchSpec,
                        want_dist: bool = False) -> None:
    """Start the raw uploads + device derive for a subsequent
    find_pairs call ON A WORKER THREAD. The CLI calls this right after
    reading the input files; the host-side staging, the (first-run)
    derive compile, and the multi-hundred-MB host->device transfer of
    a large run then genuinely overlap the duplicate-check phase —
    because jax.device_put and jit tracing/compilation block the caller
    even though the device work itself is async. The transfer/compile
    waits release the GIL, so the overlap is real even on one core.

    Indel runs (always the tile-engine route) prefetch the WHOLE
    find_pairs result instead: the device count/extract phases run
    while the host does its duplicate check, and the later find_pairs
    call just joins the worker."""
    _SPARSE_PREFETCH.clear()
    _RESULT_PREFETCH.clear()
    if spec.differences == 0:
        return  # exact path is a host hash join; nothing to upload
    mode = os.environ.get("COMPAIRR_PIGEONHOLE", "1")
    if spec.indels and spec.differences == 1:
        if mode == "all":
            return  # host indel pigeonhole; the device is never used
    elif mode != "0":
        # pigeonhole grouping handles these runs on host; only a
        # candidate-budget overflow reaches the device (rare, and the
        # tile path then creates its own inputs)
        return
    _enable_compilation_cache()
    if not on_gpu():
        return
    import threading

    if spec.indels and spec.differences == 1:
        key = (id(db1), id(db2), spec, want_dist)
        holder = [None]

        def full_work():
            try:
                holder[0] = find_pairs(
                    db1, db2, spec, want_dist=want_dist
                )
            except Exception:
                holder[0] = None  # find_pairs recomputes inline

        # insert BEFORE start so the worker's own find_pairs call sees
        # the entry and the current-thread check (not a missing key)
        # keeps it computing
        thread = threading.Thread(target=full_work, daemon=True)
        _RESULT_PREFETCH[key] = (db1, db2, thread, holder)
        thread.start()
        return

    tile, _s, lmax, by_vjl, use_indels = _pair_plan(db1, db2, spec)
    for db in [db1] if db2 is db1 else [db1, db2]:
        key = (id(db), tile, by_vjl, lmax, True, use_indels)
        if key in _SPARSE_PREFETCH:
            continue
        holder = [None]

        def work(db=db, holder=holder):
            try:
                holder[0] = _sparse_inputs(
                    db, tile, by_vjl, lmax, True, use_indels
                )
            except Exception:
                holder[0] = None  # find_pairs recomputes inline

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        _SPARSE_PREFETCH[key] = (db, thread, holder)


def variant_join_route(db1: SeqDB, db2: SeqDB, spec: MatchSpec) -> bool:
    """True when find_pairs will resolve this run through the
    asymmetric d=1 variant join (sparse_host.prepare_variant_join) —
    exposed so modes/overlap.py can precompute the join grouping
    during the duplicate-warning phase and reuse it.

    The variant join runs ONE grouping over (variants + big) rows; the
    pigeonhole runs d+1 groupings + gathers over everything. Cheaper
    while the variant rows cost less than the d extra full passes they
    replace."""
    if spec.differences != 1 or spec.indels:
        return False
    if os.environ.get("COMPAIRR_PIGEONHOLE", "1") in ("0", "all"):
        return False
    nmin = min(db1.n, db2.n)
    lmax = int(max(db1.longest, db2.longest, 1))
    alpha = 4 if db1.nucleotides else 20
    return (
        db2 is not db1
        and nmin <= (1 << 16)
        and nmin * lmax * alpha < db1.n + db2.n
    )


def find_pairs(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    logger: Optional[Logger] = None,
    progress_prompt: Optional[str] = None,
    exact_groups: Optional[tuple[np.ndarray, np.ndarray]] = None,
    vj_prep=None,
    want_dist: bool = True,
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Sparse path: all matching pairs under the spec.

    Returns (idx1, idx2, dist) in original indices, unordered.
    exact_groups optionally carries a precomputed exact_match_groups
    result (d=0 only). want_dist=False lets the Pallas tile path skip
    the host per-pair distance recompute (dist is then None or a
    byproduct array, depending on route) — only the pairs file with
    --distance ever reads it.
    """
    # a full-result prefetch (indel tile route) may already hold the
    # answer — join the worker instead of recomputing
    import threading as _threading

    rkey = (id(db1), id(db2), spec, want_dist)
    hit = _RESULT_PREFETCH.get(rkey)
    if (
        hit is not None
        and hit[0] is db1
        and hit[1] is db2
        # the worker's own find_pairs call must compute, not join itself
        and hit[2] is not _threading.current_thread()
    ):
        _RESULT_PREFETCH.pop(rkey, None)
        _d1, _d2, thread, holder = hit
        thread.join()
        if holder[0] is not None:
            if logger is not None and progress_prompt is not None:
                logger.progress_init(progress_prompt, 1)
                logger.progress_update(1)
                logger.progress_done()
            return holder[0]

    if spec.differences == 0:
        _note_route("exact")
        return _find_pairs_exact(
            db1, db2, spec, logger, progress_prompt, exact_groups
        )

    # self-comparison diagonal fast path: every sequence matches itself
    # at any d, so a same-set run excludes i==i pairs from the search
    # (they dominate the extraction volume — 24M of the 24.6M matched
    # pairs at Keck scale) and appends them afterwards for free.
    add_diagonal = db2 is db1 and not spec.exclude_self
    if add_diagonal:
        from dataclasses import replace

        spec = replace(spec, exclude_self=True)

    def with_diagonal(i1, i2, dist):
        if add_diagonal and db1.n:
            diag = np.arange(db1.n, dtype=np.int64)
            i1 = np.concatenate([diag, i1])
            i2 = np.concatenate([diag, i2])
            if dist is not None:
                dist = np.concatenate(
                    [np.zeros(db1.n, dtype=np.int64), dist]
                )
        return i1, i2, dist

    # routing: substitution-only sparse runs go through the pigeonhole
    # host path; indel runs keep the device tile engine (the indel
    # pigeonhole doubles the role-grouping volume). COMPAIRR_PIGEONHOLE=0
    # forces the tile engine everywhere, =all forces the host path for
    # indels too (the cross-check in tests/test_oracle.py uses both).
    mode = os.environ.get("COMPAIRR_PIGEONHOLE", "1")
    if mode != "0":
        if spec.indels and spec.differences == 1:
            route = "pigeonhole_indel"
            ph = (
                _find_pairs_pigeonhole_indel(
                    db1, db2, spec, logger, progress_prompt
                )
                if mode == "all"
                else None
            )
        else:
            if vj_prep is not None or variant_join_route(db1, db2, spec):
                route = "variant_join"
                ph = _find_pairs_variant_join(
                    db1, db2, spec, logger, progress_prompt, prep=vj_prep
                )
            else:
                route = "pigeonhole"
                ph = _find_pairs_pigeonhole(
                    db1, db2, spec, logger, progress_prompt
                )
        if ph is not None:
            _note_route(route)
            return with_diagonal(*ph)

    _note_route("tiles")

    _enable_compilation_cache()
    gpu = on_gpu()
    tm = _PhaseTimer()
    tm.mark()
    tile, s_extract, lmax, by_vjl, use_indels = _pair_plan(db1, db2, spec)
    tm.lap("pair_plan")
    delta = 1 if use_indels else 0
    a_in, orig_a, key_a, npad_a = _sparse_inputs_cached(
        db1, tile, by_vjl, lmax, gpu, use_indels
    )
    if db2 is db1:
        b_in, orig_b, key_b, npad_b = a_in, orig_a, key_a, npad_a
    else:
        b_in, orig_b, key_b, npad_b = _sparse_inputs_cached(
            db2, tile, by_vjl, lmax, gpu, use_indels
        )
    tm.lap("inputs")

    work = worklist_from_keys(
        key_a, db1.n, key_b, db2.n, delta, tile, tile
    )
    # per-tile kernel classes: Hamming-only tiles skip the prefix/suffix
    # loops, pure-±1 tiles skip the mismatch count, and tiles that can
    # hold no key-compatible pair at all are dropped before the count
    # phase ever sees them
    has_eq, has_pm = classify_worklist(
        work, key_a, db1.n, key_b, db2.n, tile, tile
    )
    if delta:
        streams = [
            (work[has_eq & ~has_pm], False, False),
            (work[has_eq & has_pm], True, False),
            (work[~has_eq & has_pm], True, True),
        ]
    else:
        streams = [(work[has_eq], False, False)]
    # column-major order: tiles launched together share their b-block
    # (L2 reuse). The pair set is order-invariant (consumers
    # reconstruct the canonical order from indices).
    streams = [
        (order_colmajor(sw), si, so)
        for sw, si, so in streams
        if len(sw)
    ]
    w = sum(len(s[0]) for s in streams)
    tm.lap("worklist")

    if logger is not None and progress_prompt is not None:
        logger.progress_init(progress_prompt, max(w, 1))

    out1: list[np.ndarray] = []
    out2: list[np.ndarray] = []

    if w:
        from . import gpu_kernels

        dummy = np.array([[npad_a - tile, npad_b - tile]], dtype=np.int32)
        kernel_kw = dict(
            differences=spec.differences, exclude_self=spec.exclude_self
        )

        # multi-device: replicate both packed sets onto every device and
        # give each device a contiguous span of the tile worklist.
        devs = _sparse_devices()
        n_dev = max(1, min(len(devs), w // _TILES_PER_DEVICE_MIN))
        combo = (a_in, b_in)
        replicas = [combo] + [
            _put_tree(combo, devs[di]) for di in range(1, n_dev)
        ]

        # phase 1: per-tile match counts; drop empty tiles and use the
        # exact counts to bound each extraction dispatch's record
        # buffer. On a GPU this is the Triton count kernel (the XLA
        # scan runs one tiny tile per step).
        filtered = []  # (work, tile_counts, s_indels, s_ionly)
        for swork, s_ind, s_io in streams:
            sw = len(swork)
            nd = max(1, min(n_dev, sw // _TILES_PER_DEVICE_MIN))
            span = [sw * di // nd for di in range(nd + 1)]
            cnt_parts: list = []
            for di in range(nd):
                cw = swork[span[di] : span[di + 1]]
                if len(cw) == 0:
                    continue
                ra, rb = replicas[di]
                if gpu:
                    parts = gpu_kernels.count_tiles(
                        ra, rb, cw, indels=s_ind, indel_only=s_io,
                        **kernel_kw,
                    )
                else:
                    parts = [
                        _count_fn(
                            spec, tile, tile,
                            indels_ov=s_ind, indel_only=s_io,
                        )(
                            *ra, *rb,
                            jax.device_put(
                                pad_worklist_n(
                                    cw, npad_a, npad_b, tile, tile
                                ),
                                devs[di],
                            ),
                        )
                    ]
                cnt_parts.append((parts, len(cw)))
            counts = np.concatenate([
                np.concatenate([np.asarray(p) for p in parts])[:c]
                for parts, c in cnt_parts
            ])
            nonzero = counts > 0
            filtered.append(
                (swork[nonzero], counts[nonzero], s_ind, s_io)
            )

        # phase 2: greedy-pack tiles into slabs of <= s_extract tiles
        # and <= k_cap total matches (matched words <= matches, so the
        # word buffer can't overflow), extract packed match words.
        # match-dense workloads (e.g. huge self-compares at d=0) fill
        # the word buffer long before the tile bound; a bigger buffer
        # costs download bytes but saves whole dispatches
        tm.lap("count")
        total_matches = sum(int(tc.sum()) for _, tc, _, _ in filtered)
        k_cap = K_EXTRACT_BIG if total_matches > (1 << 20) else K_EXTRACT

        def make_run_slab(s_ind, s_io):
            # k (the record-buffer size, and so the download size) is a
            # per-slab pow2 sized from the slab's EXACT match count.
            # One cached compile per (kernel class, k) rung.
            if gpu:
                def run_slab(slab, di, k):
                    ra, rb = replicas[di]
                    return gpu_kernels.extract_tiles(
                        ra, rb, slab, indels=s_ind, indel_only=s_io, k=k,
                        **kernel_kw,
                    )
            else:
                def run_slab(slab, di, k):
                    run = _extract_fn(
                        spec, tile, tile, len(slab), k,
                        indels_ov=s_ind, indel_only=s_io,
                    )
                    ra, rb = replicas[di]
                    return run(*ra, *rb, jax.device_put(slab, devs[di]))

            return run_slab

        wpr = tile // 32  # match-bit words per tile row
        wpt = tile * wpr  # words per tile

        # dispatch slabs asynchronously a bounded WINDOW ahead (device
        # queues the work; slabs round-robin across the device
        # replicas) and download as the window fills: D2H transfers
        # overlap the remaining slab compute without queueing the
        # whole run — an unbounded queue would hold every pending
        # dispatch's output + workspace on device at once.
        from collections import deque

        window = max(
            1, int(os.environ.get("COMPAIRR_EXTRACT_INFLIGHT", "16"))
        ) * max(1, n_dev)
        pending: deque = deque()
        done = 0

        def consume():
            nonlocal done
            slab, nreal, res = pending.popleft()
            # one batched D2H for all three outputs
            widx, wvals, cnt = jax.device_get(res)
            cnt = int(cnt)
            widx = widx[:cnt].astype(np.int64)
            wvals = wvals[:cnt].astype(np.uint32)
            if cnt:
                tz = widx // wpt
                mz = (widx % wpt) // wpr
                wc = widx % wpr
                ra = slab[tz, 0].astype(np.int64)
                rb = slab[tz, 1].astype(np.int64)
                for b in range(32):
                    sel = np.nonzero(
                        (wvals >> np.uint32(b)) & np.uint32(1)
                    )[0]
                    if len(sel):
                        out1.append(orig_a[ra[sel] + mz[sel]])
                        out2.append(orig_b[rb[sel] + wc[sel] * 32 + b])
            done += nreal
            if logger is not None and progress_prompt is not None:
                logger.progress_update(done)

        di = 0
        for fwork, tile_counts, s_ind, s_io in filtered:
            run_slab = make_run_slab(s_ind, s_io)
            fw = len(fwork)
            s0 = 0
            while s0 < fw:
                s1 = s0
                acc = 0
                while (
                    s1 < fw
                    and s1 - s0 < s_extract
                    and acc + tile_counts[s1] <= k_cap
                ):
                    acc += tile_counts[s1]
                    s1 += 1
                # forced progress: a single tile can't exceed k_cap
                # (tile*tile <= K_EXTRACT), but an empty slab must
                # never loop forever
                s1 = max(s1, s0 + 1)
                slab = fwork[s0:s1]
                nreal = len(slab)
                # pad to a pow2 ladder: one compile per rung, and a
                # short slab does not pay for s_extract dummy tiles
                target = gpu_kernels.launch_len(nreal)
                if nreal < target:
                    slab = np.concatenate(
                        [slab, np.repeat(dummy, target - nreal, axis=0)]
                    )
                k_slab = 1 << max(
                    12, int(max(acc, 1) - 1).bit_length()
                )  # pow2 >= acc (matched words <= matches)
                pending.append((slab, nreal, run_slab(slab, di, k_slab)))
                di = (di + 1) % n_dev
                s0 = s1
                while len(pending) >= window:
                    consume()

        tm.lap("extract_dispatch")
        while pending:
            consume()

    if logger is not None and progress_prompt is not None:
        logger.progress_done()
    tm.lap("download_unpack")

    if out1:
        i1 = np.concatenate(out1)
        i2 = np.concatenate(out2)
        dist = (
            _pair_distances(db1, db2, i1, i2) if want_dist else None
        )
        tm.lap("distances")
        res = with_diagonal(i1, i2, dist)
        tm.lap("diagonal")
        tm.report(f"find_pairs tiles={w} pairs={len(res[0])}")
        return res
    tm.report(f"find_pairs tiles={w} pairs=0")
    z = np.zeros(0, dtype=np.int64)
    return with_diagonal(z, z, z.copy())
