"""Triton kernels (Pallas, backend="triton") for the sparse tile engine.

Phase 1 (count) returns each worklist tile's match count; phase 2
(extract) returns each tile's match mask packed into uint32 words, 32
columns per word, which a jnp epilogue compacts to the nonzero words.
Both evaluate the same predicate as engine._tile_match, the plain XLA
reference that the CPU backend runs and the tests compare against.

One program handles one TILE x TILE worklist tile. It loads its own
(row, column) block starts from the worklist, so the grid needs no
scalar prefetch. Inside, it walks the tile's columns in GROUP-wide
blocks. For each block it first forms the bucket precondition from the
(v, j) group and the length rows: equal buckets for Hamming, lengths
one apart in the same (v, j) for one indel. Blocks where no pair meets
it skip the residue work. Otherwise a loop over the residue positions
reads one position of the row block and one of the column block
(contiguous, from the position-major layouts of ops/derive.py) and
keeps per-pair int32 counters in registers:
  * Hamming: mismatches, from a compare per position (on an H100 this
    beat an int8 one-hot product per position on the tensor cores:
    0.19 vs 0.23 us per tile on the Keck d=2 worklist);
  * one indel: the common prefix and, over the per-row reversed rows,
    the common suffix, as running ANDs of the per-position equality.
A pair with lengths one apart is one indel apart iff prefix + suffix
>= the shorter length (the reference's deletion check).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..utils.lazyjax import jax, jnp, lax

TILE = 128  # worklist tile = kernel block, rows and columns
GROUP = 32  # column block per inner step = bits per extracted word
CHUNK = 1 << 20  # most tiles per kernel launch (bounds worklist bytes)
NUM_WARPS = 4
NUM_STAGES = 2


def _tile_kernel(rows_ref, cols_ref, *refs, differences: int, indels: bool,
                 indel_only: bool, exclude_self: bool, lmax: int,
                 words: bool):
    """One worklist tile. refs: a-side (seqs, [rseqs], grp, len, orig),
    b-side likewise, then the output: int32[n_tiles] counts, or (words)
    int32[n_tiles, TILE, TILE // GROUP] match bits."""
    from jax.experimental import pallas as pl

    per_set = 5 if indels else 4
    a_refs = refs[:per_set]
    b_refs = refs[per_set : 2 * per_set]
    out_ref = refs[2 * per_set]
    if indels:
        a_seq, a_rseq, a_grp, a_len, a_orig = a_refs
        b_seq, b_rseq, b_grp, b_len, b_orig = b_refs
    else:
        a_seq, a_grp, a_len, a_orig = a_refs
        b_seq, b_grp, b_len, b_orig = b_refs
        a_rseq = b_rseq = None
    hamming = not indel_only

    i = pl.program_id(0)
    rows = pl.ds(pl.multiple_of(rows_ref[i], TILE), TILE)
    c0 = pl.multiple_of(cols_ref[i], TILE)
    ga = a_grp[rows]
    la = a_len[rows]
    oa = a_orig[rows] if exclude_self else None
    bits = jnp.left_shift(
        jnp.int32(1), lax.broadcasted_iota(jnp.int32, (1, GROUP), 1)
    )

    def group_mask(g):
        cols = pl.ds(pl.multiple_of(c0 + g * GROUP, GROUP), GROUP)
        gb = b_grp[cols]
        lb = b_len[cols]
        same = (
            (ga[:, None] == gb[None, :])
            & (la[:, None] > 0)
            & (lb[None, :] > 0)
        )
        if exclude_self:
            same = same & (oa[:, None] != b_orig[cols][None, :])
        dl = la[:, None] - lb[None, :]
        keq = same & (dl == 0) if hamming else None
        kpm = same & ((dl == 1) | (dl == -1)) if indels else None
        if keq is None:
            cand = kpm
        elif kpm is None:
            cand = keq
        else:
            cand = keq | kpm
        zeros = jnp.zeros((TILE, GROUP), jnp.int32)

        def residues():
            def fwd(p, st):
                mism, alive, pref = st
                eq = a_seq[p, rows][:, None] == b_seq[p, cols][None, :]
                if hamming:
                    mism = mism + jnp.where(eq, 0, 1)
                if indels:
                    alive = alive & jnp.where(eq, 1, 0)
                    pref = pref + alive
                return mism, alive, pref

            ones = jnp.ones((TILE, GROUP), jnp.int32)
            mism, _, pref = lax.fori_loop(0, lmax, fwd, (zeros, ones, zeros))
            match = keq & (mism <= differences) if hamming else None
            if indels:

                def rev(p, st):
                    alive, suf = st
                    eq = (
                        a_rseq[p, rows][:, None] == b_rseq[p, cols][None, :]
                    )
                    alive = alive & jnp.where(eq, 1, 0)
                    return alive, suf + alive

                _, suf = lax.fori_loop(0, lmax, rev, (ones, zeros))
                minlen = jnp.minimum(la[:, None], lb[None, :])
                one_indel = kpm & (pref + suf >= minlen)
                match = one_indel if match is None else match | one_indel
            return jnp.where(match, 1, 0)

        return lax.cond(
            jnp.max(jnp.where(cand, 1, 0)) > 0, residues, lambda: zeros
        )

    if words:

        @pl.loop(0, TILE // GROUP)
        def _(g):
            m = group_mask(g)
            # distinct powers of two: the wrapping int32 sum is their OR
            out_ref[i, :, g] = jnp.sum(m * bits, axis=1)

    else:

        def count(g, acc):
            return acc + jnp.sum(group_mask(g))

        out_ref[i] = lax.fori_loop(0, TILE // GROUP, count, jnp.int32(0))


def _set_args(p: dict, indels: bool) -> tuple:
    keys = ("seqs", "rseqs", "grp", "len", "orig") if indels else (
        "seqs", "grp", "len", "orig"
    )
    return tuple(p[k] for k in keys)


@lru_cache(maxsize=None)
def _tiles_call(n_tiles: int, *, differences: int, indels: bool,
                indel_only: bool, exclude_self: bool, lmax: int,
                words: bool, interpret: bool):
    import functools

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    out_shape = (
        jax.ShapeDtypeStruct((n_tiles, TILE, TILE // GROUP), jnp.int32)
        if words
        else jax.ShapeDtypeStruct((n_tiles,), jnp.int32)
    )
    return pl.pallas_call(
        functools.partial(
            _tile_kernel, differences=differences, indels=indels,
            indel_only=indel_only, exclude_self=exclude_self, lmax=lmax,
            words=words,
        ),
        out_shape=out_shape,
        grid=(n_tiles,),
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        backend="triton",
        name="extract_tiles" if words else "count_tiles",
    )


def launch_len(c: int) -> int:
    """Launch grid size for c tiles: the next power of two (at least 8),
    so one compile serves every worklist of that size class."""
    return max(8, 1 << (max(c, 1) - 1).bit_length())


def _padded(work: np.ndarray, target: int, dummy: np.ndarray) -> np.ndarray:
    """Worklist padded with tiles aimed at the all-padding block, whose
    rows have no bucket and so never match (zero contribution)."""
    if len(work) == target:
        return work
    return np.concatenate(
        [work, np.repeat(dummy[None, :], target - len(work), axis=0)]
    )


def _dummy(pa: dict, pb: dict) -> np.ndarray:
    return np.array(
        [pa["grp"].shape[0] - TILE, pb["grp"].shape[0] - TILE], np.int32
    )


def _device_of(x):
    (dev,) = x.devices()
    return dev


def count_tiles(pa: dict, pb: dict, work: np.ndarray, *, differences: int,
                indels: bool, indel_only: bool, exclude_self: bool,
                interpret: bool = False) -> list:
    """Per-tile match counts for a worklist of (row, column) element
    starts. Returns device int32 arrays, one per launch, whose
    concatenation (trimmed to len(work)) lines up with `work`."""
    lmax = int(pa["seqs"].shape[0])
    dev = _device_of(pa["grp"])
    args = (*_set_args(pa, indels), *_set_args(pb, indels))
    dummy = _dummy(pa, pb)
    outs = []
    for s0 in range(0, len(work), CHUNK):
        chunk = work[s0 : s0 + CHUNK]
        chunk = _padded(chunk, launch_len(len(chunk)), dummy)
        fn = _tiles_call(
            len(chunk), differences=differences, indels=indels,
            indel_only=indel_only, exclude_self=exclude_self, lmax=lmax,
            words=False, interpret=interpret,
        )
        outs.append(
            fn(
                jax.device_put(chunk[:, 0].copy(), dev),
                jax.device_put(chunk[:, 1].copy(), dev),
                *args,
            )
        )
    return outs


def compact_words(words, k: int):
    """Nonzero (flat index, word) records of a [tiles, TILE, wpr] word
    array, in ascending index order, in a fixed [k] buffer, plus their
    count. Two levels: a nonzero over the 32x smaller "block of 32
    words has any bit" flags first, then over the gathered blocks
    only."""
    flat = words.reshape(-1)
    blocks = flat.reshape(-1, 32)
    flags = jnp.any(blocks != 0, axis=1)
    bcnt = jnp.sum(flags.astype(jnp.int32))
    (bidx,) = jnp.nonzero(flags, size=k, fill_value=0)
    sub = jnp.take(blocks, bidx, axis=0)  # [k, 32]
    # rows past bcnt replay block bidx[0] (the fill value), whose words
    # may be real matches: mask them out
    sub = jnp.where(jnp.arange(k, dtype=jnp.int32)[:, None] < bcnt, sub, 0)
    subf = sub.reshape(-1)
    count = jnp.sum((subf != 0).astype(jnp.int32))
    (p2,) = jnp.nonzero(subf, size=k, fill_value=0)
    vals = jnp.take(subf, p2)
    idx = bidx[p2 // 32] * 32 + (p2 % 32)
    return idx.astype(jnp.int32), vals, count


@lru_cache(maxsize=None)
def _extract_fn(n_tiles: int, k: int, **kw):
    call = _tiles_call(n_tiles, words=True, **kw)

    @jax.jit
    def run(rows, cols, *args):
        words = lax.bitcast_convert_type(call(rows, cols, *args), jnp.uint32)
        return compact_words(words, k)

    return run


def extract_tiles(pa: dict, pb: dict, slab: np.ndarray, *, differences: int,
                  indels: bool, indel_only: bool, exclude_self: bool, k: int,
                  interpret: bool = False):
    """Packed match words of one extraction slab, compacted on device:
    returns (word_indices int32[k], word_bits uint32[k], count) over
    the slab's [len(slab), TILE, TILE // 32] word array, the layout
    engine._extract_fn produces."""
    dev = _device_of(pa["grp"])
    fn = _extract_fn(
        len(slab), k, differences=differences, indels=indels,
        indel_only=indel_only, exclude_self=exclude_self,
        lmax=int(pa["seqs"].shape[0]), interpret=interpret,
    )
    return fn(
        jax.device_put(slab[:, 0].copy(), dev),
        jax.device_put(slab[:, 1].copy(), dev),
        *_set_args(pa, indels),
        *_set_args(pb, indels),
    )
