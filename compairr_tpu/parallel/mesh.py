"""Multi-device distribution of the dense overlap computation.

The reference's only parallelism is pthreads over set-1 seeds with
mutex-merged thread-local matrices (src/overlap.cc:376-538, threads.h).
The device equivalent: shard set-1 rows across a 1-D device mesh,
replicate (or ring-stream) set 2, run the dense grid accumulation per
shard, and merge the per-shard [R1, R2] partial matrices with a psum —
the collective analogue of the reference's mutex-guarded matrix merge
(overlap.cc:512-527). The cards of one host reach each other all to
all over NVLink, so the mesh is a plain 1-D axis.

Worklists are built per shard on host (each shard sees its own row
lengths) and padded to a common length with dummy all-padding tiles so
the SPMD program has identical shape on every device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..core.db import SeqDB
from ..ops.engine import (
    MatchSpec,
    PackedSet,
    TILE_M,
    TILE_N,
    _F32_EXACT_LIMIT,
    _block_rep_stats,
    _enable_compilation_cache,
    _host_tiles_matrix,
    _round_up,
    _tile_exact_bounds,
    dense_tile_contrib,
    pack_set,
)

# this module is device-only (jax already imported above): make the
# persistent compile cache cover its shard_map jits even when the
# engine's device entry points were never hit in this process
_enable_compilation_cache()

# Phase/tile statistics of the last dense_matrix_sharded call, for
# overhead attribution (scripts/weak_scaling.py): prep phases are
# host-serial in this single-process harness but per-host-parallel in
# a real multi-host run (COMPAIRR_INPUT_SHARD), so the compute phase
# is the number weak-scaling efficiency should be judged on.
LAST_STATS: dict = {}


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host initialisation: one process per host, all chips of
    all hosts form the global device mesh afterwards
    (jax.distributed). Parameters default to the standard JAX
    environment variables (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID); a single-process environment is a no-op. The
    reference has no multi-node capability at all (SURVEY.md: pthreads
    only) — this replaces its manual split-and-merge advice."""
    import os

    if (
        coordinator_address is None
        and num_processes is None
        and process_id is None
        and "JAX_COORDINATOR_ADDRESS" not in os.environ
        and "COMPAIRR_DISTRIBUTED" not in os.environ
    ):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def _global_put(mesh: Mesh, pspec: P, host_arr: np.ndarray):
    """Host-replicated numpy -> jax.Array laid out per `pspec` over
    `mesh`. Single-process: each shard goes straight to its own device
    (nothing is staged on device 0). Multi-process (after
    initialize_distributed): every process holds the same full host
    copy and contributes its addressable shards via
    make_array_from_callback."""
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, pspec)
    if jax.process_count() == 1:
        return jax.device_put(host_arr, sh)
    return jax.make_array_from_callback(
        host_arr.shape, sh, lambda idx: host_arr[idx]
    )


def _equal_span_bounds(n: int, n_shards: int):
    per = -(-n // n_shards) if n else 0
    return [
        (min(k * per, n), min(min(k * per, n) + per, n))
        for k in range(n_shards)
    ]


def _balanced_bounds(
    a: PackedSet, b: PackedSet, spec: MatchSpec, tile_m: int,
    tile_n: int, n_shards: int,
):
    """Contiguous block-aligned set-1 row spans with ~equal worklist
    TILE counts per shard. The SPMD worklists are padded to the
    longest shard's length with dummy all-pad tiles that still cost a
    full tile of compute, so equal row spans (whose tile counts
    diverge with the length/gene distribution of the sorted packing)
    make every shard pay the busiest shard's wall. Splitting at the
    quantiles of the cumulative per-row-block tile counts balances
    compute instead — the sharding analogue of the reference's
    dynamic chunk scheduling (src/overlap.cc:421-434).
    Cuts stay on tile_m block boundaries, so each shard's re-packed
    blocks coincide with the full packing's and per-shard worklists
    recover exactly the planned per-block tiles."""
    from ..ops.engine import worklist_from_keys

    nblocks = max(a.np_ // tile_m, 1)
    if nblocks < 4 * n_shards:
        # too few blocks to balance at block granularity: equal row
        # spans re-pack each shard into its own (finer) blocks and
        # win on tiny sets
        return _equal_span_bounds(a.n, n_shards)
    delta = 1 if (spec.indels and spec.differences == 1) else 0
    full = worklist_from_keys(
        a.key, a.n, b.key, b.n, delta, tile_m, tile_n
    )
    if len(full) == 0:
        return _equal_span_bounds(a.n, n_shards)
    counts = np.bincount(
        full[:, 0] // tile_m, minlength=nblocks
    )
    prefix = np.cumsum(counts)
    total = int(prefix[-1])
    cuts = [0]
    for k in range(1, n_shards):
        target = total * k / n_shards
        cut = int(np.searchsorted(prefix, target, side="left")) + 1
        cuts.append(max(min(cut, nblocks), cuts[-1]))
    cuts.append(nblocks)
    return [
        (
            min(cuts[k] * tile_m, a.n),
            a.n if k == n_shards - 1 else min(cuts[k + 1] * tile_m, a.n),
        )
        for k in range(n_shards)
    ]


def _shard_packed(
    a: PackedSet, n_shards: int, tile_m: int, bounds=None
):
    """Split a packed (length-sorted) set into n_shards contiguous row
    chunks of identical padded size; returns stacked
    [n_shards, chunk, ...] arrays plus the per-shard (lo, hi) row
    bounds. Default bounds are equal row spans; pass _balanced_bounds
    output to balance by worklist tile count instead."""
    n = a.n
    if bounds is None:
        bounds = _equal_span_bounds(n, n_shards)
    span = max((hi - lo for lo, hi in bounds), default=0)
    chunk = _round_up(span, tile_m) + tile_m  # + one all-pad dummy tile

    def stack(x: np.ndarray, pad_value) -> np.ndarray:
        shape = (n_shards, chunk) + x.shape[1:]
        out = np.full(shape, pad_value, dtype=x.dtype)
        for k, (lo, hi) in enumerate(bounds):
            if hi > lo:
                out[k, : hi - lo] = x[lo:hi]
        return out

    pad_seq = a.seqs[-1, 0]  # pad rows are all pad_value
    stacked = dict(
        seqs=stack(a.seqs[:n], pad_seq),
        rseqs=stack(a.rseqs[:n], pad_seq),
        lengths=stack(a.lengths[:n], a.lengths[-1]),
        v=stack(a.v[:n], -1),
        j=stack(a.j[:n], -1),
        rep=stack(a.rep[:n], -1),
        counts=stack(a.counts[:n], 0.0),
        key=stack(a.key[:n], a.key[-1]),
    )
    return stacked, chunk, bounds


def _shard_worklists(
    stacked_keys: np.ndarray,
    bounds,
    b: PackedSet,
    spec: MatchSpec,
    tile_m: int,
    tile_n: int,
    chunk: int,
):
    """Per-shard tile worklists (local row starts), padded to a common
    length with dummy tiles aimed at each shard's pad rows."""
    from ..ops.engine import worklist_from_keys

    n_shards = stacked_keys.shape[0]
    delta = 1 if (spec.indels and spec.differences == 1) else 0
    lists = []
    for k in range(n_shards):
        lo, hi = bounds[k]
        lists.append(
            worklist_from_keys(
                stacked_keys[k], hi - lo, b.key, b.n, delta, tile_m,
                tile_n,
            )
        )
    wmax = max(max((len(t) for t in lists), default=0), 1)
    work = np.zeros((n_shards, wmax, 2), dtype=np.int32)
    work[:, :, 0] = chunk - tile_m  # dummy: shard's all-pad tile
    work[:, :, 1] = b.np_ - tile_n
    for k, tiles in enumerate(lists):
        if len(tiles):
            work[k, : len(tiles)] = tiles
    return work, lists


def dense_matrix_sharded(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    score_int: int,
    ignore_counts: bool,
    devices: Optional[Sequence] = None,
    tile_m: int = TILE_M,
    tile_n: int = TILE_N,
) -> np.ndarray:
    """[R1, R2] overlap matrix computed SPMD over a 1-D device mesh."""
    if spec.exclude_self:
        raise ValueError(
            "dense paths do not support exclude_self specs; use "
            "find_pairs (the sparse engine) for cluster-style matching"
        )
    import time as _time

    devices = list(devices if devices is not None else jax.devices())
    n_shards = len(devices)
    mesh = Mesh(np.asarray(devices), ("shard",))

    t0 = _time.perf_counter()
    lmax = int(max(db1.longest, db2.longest, 1))
    by_vjl = not spec.ignore_genes
    use_indels = spec.indels and spec.differences == 1
    a = pack_set(db1, lmax, tile_m, by_vjl, need_rseqs=use_indels)
    b = (
        a
        if db2 is db1 and tile_m == tile_n
        else pack_set(db2, lmax, tile_n, by_vjl, need_rseqs=use_indels)
    )
    t_pack = _time.perf_counter() - t0

    t0 = _time.perf_counter()
    import os as _os_bal

    balance = _os_bal.environ.get("COMPAIRR_SHARD_BALANCE", "1") != "0"
    bounds = (
        _balanced_bounds(a, b, spec, tile_m, tile_n, n_shards)
        if balance
        else None
    )
    stacked, chunk, bounds = _shard_packed(
        a, n_shards, tile_m, bounds=bounds
    )
    work, lists = _shard_worklists(
        stacked["key"], bounds, b, spec, tile_m, tile_n, chunk
    )
    t_shard = _time.perf_counter() - t0
    real_tiles = [int(len(t)) for t in lists]
    LAST_STATS.clear()
    LAST_STATS.update(
        devices=n_shards,
        pack_s=t_pack,
        shard_s=t_shard,
        real_tiles=real_tiles,
        padded_tiles_per_shard=int(work.shape[1]),
        pad_fraction=1.0
        - (sum(real_tiles) / max(n_shards * work.shape[1], 1)),
    )

    r1p = _round_up(max(db1.repertoire_count, 1), 8)
    r2p = _round_up(max(db2.repertoire_count, 1), 128)
    spec_kw = dict(
        differences=spec.differences,
        indels=spec.indels and spec.differences == 1,
        ignore_genes=spec.ignore_genes,
    )

    def per_shard(a_stack, b_args, starts):
        # shard_map blocks keep the leading (sharded) axis of size 1
        a_args = tuple(x[0] for x in a_stack)
        starts = starts[0]

        def step(acc, st):
            contrib = dense_tile_contrib(
                a_args, b_args, st[0], st[1],
                spec_kw=spec_kw, score_int=score_int,
                ignore_counts=ignore_counts, r1p=r1p, r2p=r2p,
                tile_m=tile_m, tile_n=tile_n,
            )
            return acc + contrib, None

        # mark the carry as device-varying so the scan carry type is
        # stable under shard_map's varying-manual-axes tracking
        zeros = jnp.zeros((r1p, r2p), dtype=jnp.float32)
        if hasattr(lax, "pcast"):
            acc0 = lax.pcast(zeros, "shard", to="varying")
        else:  # older jax
            acc0 = lax.pvary(zeros, "shard")
        acc, _ = lax.scan(step, acc0, (starts[:, 0], starts[:, 1]))
        return lax.psum(acc, "shard")

    t0 = _time.perf_counter()
    a_stack = tuple(
        _global_put(mesh, P("shard"), stacked[k])
        for k in ("seqs", "rseqs", "lengths", "v", "j", "rep", "counts")
    )
    b_args = tuple(
        _global_put(mesh, P(), x)
        for x in (b.seqs, b.rseqs, b.lengths, b.v, b.j, b.rep, b.counts)
    )
    jax.block_until_ready((a_stack, b_args))
    LAST_STATS["put_s"] = _time.perf_counter() - t0

    shard_spec = tuple(P("shard") for _ in a_stack)
    rep_spec = tuple(P() for _ in b_args)
    fn = jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(shard_spec, rep_spec, P("shard")),
            out_specs=P(),
        )
    )

    # f32 exactness guard (see engine._plan_exact_chunks): the per-cell
    # budget covers the psum across shards too, since the merged result
    # is still f32 — chunks are co-packed across shards under one
    # global 2^24 budget and the per-chunk [R1, R2] partials are summed
    # in f64 on host. Pathological tiles run on the exact host path.
    import os as _os

    guard = _os.environ.get("COMPAIRR_DENSE_EXACT", "1") != "0"
    plan = None
    if guard:
        nrep1 = max(db1.repertoire_count, 1)
        nrep2 = max(db2.repertoire_count, 1)
        stats_b = _block_rep_stats(
            b.rep, b.counts, b.n, tile_n, b.np_ // tile_n, nrep2
        )
        per_bounds = []
        total = 0.0
        applicable = True
        for k, tiles in enumerate(lists):
            lo, hi = bounds[k]
            stats_ak = _block_rep_stats(
                a.rep[lo:hi], a.counts[lo:hi], hi - lo, tile_m,
                chunk // tile_m, nrep1,
            )
            if len(tiles) == 0:
                per_bounds.append((stats_ak, np.zeros(0)))
                continue
            bd = _tile_exact_bounds(
                tiles, stats_ak, stats_b, tile_m, tile_n,
                score_int, ignore_counts,
            )
            if bd is None:
                applicable = False
                break
            per_bounds.append((stats_ak, bd))
            total += float(bd.sum())
        if applicable and total >= _F32_EXACT_LIMIT:
            plan = _plan_sharded_chunks(
                lists, [bd for _, bd in per_bounds]
            )

    if plan is None:
        d_work = _global_put(mesh, P("shard"), work)
        jax.block_until_ready(d_work)
        t0 = _time.perf_counter()
        acc = np.asarray(fn(a_stack, b_args, d_work)).astype(np.float64)
        LAST_STATS["compute_s"] = _time.perf_counter() - t0
    else:
        chunks, host_tiles = plan
        wc_max = max(
            (len(t) for cur in chunks for t in cur), default=1
        )
        wc_max = max(wc_max, 1)
        acc = np.zeros((r1p, r2p), dtype=np.float64)
        t0 = _time.perf_counter()
        for cur in chunks:
            cw = np.zeros((n_shards, wc_max, 2), dtype=np.int32)
            cw[:, :, 0] = chunk - tile_m
            cw[:, :, 1] = b.np_ - tile_n
            for k, tiles in enumerate(cur):
                if len(tiles):
                    cw[k, : len(tiles)] = tiles
            acc += np.asarray(
                fn(a_stack, b_args, _global_put(mesh, P("shard"), cw))
            ).astype(np.float64)
        LAST_STATS["compute_s"] = _time.perf_counter() - t0
        for k, tiles in enumerate(host_tiles):
            if len(tiles) == 0:
                continue
            lo, hi = bounds[k]
            orig_k = np.full(chunk, -1, dtype=np.int64)
            orig_k[: hi - lo] = a.orig[lo:hi]
            acc += _host_tiles_matrix(
                db1, db2, orig_k, b.orig, np.asarray(tiles), spec,
                score_int, ignore_counts, r1p, r2p, tile_m, tile_n,
            )
    return acc[: db1.repertoire_count, : db2.repertoire_count].astype(
        np.float64
    )


def _plan_sharded_chunks(lists, per_bounds):
    """Co-pack the per-shard worklists into chunks whose COMBINED
    (post-psum) f32 partial stays exact: each chunk takes a prefix of
    every shard's remaining tiles under one global 2^24 budget.
    Returns (chunks, host_tiles): chunks is a list of per-shard tile
    arrays, host_tiles the per-shard tiles whose own bound crosses the
    limit (computed exactly on host instead)."""
    n_shards = len(lists)
    rest, rbounds, host = [], [], []
    for k in range(n_shards):
        bd = per_bounds[k]
        tiles = lists[k]
        if len(tiles) == 0:
            rest.append(np.zeros((0, 2), dtype=np.int32))
            rbounds.append(np.zeros(0))
            host.append(np.zeros((0, 2), dtype=np.int32))
            continue
        heavy = bd >= _F32_EXACT_LIMIT
        host.append(tiles[heavy])
        rest.append(tiles[~heavy])
        rbounds.append(bd[~heavy])
    csums = [np.cumsum(bd) for bd in rbounds]
    ptr = [0] * n_shards
    chunks = []
    while any(ptr[k] < len(rest[k]) for k in range(n_shards)):
        budget = _F32_EXACT_LIMIT
        cur = []
        for k in range(n_shards):
            p = ptr[k]
            if p >= len(rest[k]) or budget <= 0:
                cur.append(rest[k][:0])
                continue
            base = csums[k][p - 1] if p else 0.0
            end = int(
                np.searchsorted(csums[k], base + budget, side="left")
            )
            cur.append(rest[k][p:end])
            if end > p:
                budget -= float(csums[k][end - 1] - base)
                ptr[k] = end
        if not any(len(t) for t in cur):
            # budget too small for any shard's next tile: force one
            for k in range(n_shards):
                if ptr[k] < len(rest[k]):
                    cur[k] = rest[k][ptr[k] : ptr[k] + 1]
                    ptr[k] += 1
                    break
        chunks.append(cur)
    return chunks, host


def dense_matrix_ring(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    score_int: int,
    ignore_counts: bool,
    devices: Optional[Sequence] = None,
    tile_m: int = TILE_M,
    tile_n: int = TILE_N,
) -> np.ndarray:
    """[R1, R2] overlap matrix with BOTH sets sharded: set-1 rows stay
    resident per device, set-2 shards rotate around the ring with
    lax.ppermute so every device sees every block — the device form
    of the reference README's manual split-and-merge advice. Per-device
    set-2 memory is 1/n of dense_matrix_sharded's replicated copy;
    per-step compute overlaps the next block's permute (XLA schedules
    the collective asynchronously)."""
    if spec.exclude_self:
        raise ValueError(
            "dense paths do not support exclude_self specs; use "
            "find_pairs (the sparse engine) for cluster-style matching"
        )
    devices = list(devices if devices is not None else jax.devices())
    n_shards = len(devices)
    mesh = Mesh(np.asarray(devices), ("shard",))

    lmax = int(max(db1.longest, db2.longest, 1))
    by_vjl = not spec.ignore_genes
    use_indels = spec.indels and spec.differences == 1
    a = pack_set(db1, lmax, tile_m, by_vjl, need_rseqs=use_indels)
    b = a if db2 is db1 and tile_m == tile_n else pack_set(
        db2, lmax, tile_n, by_vjl, need_rseqs=use_indels
    )

    a_stacked, a_chunk, a_bounds = _shard_packed(a, n_shards, tile_m)
    b_stacked, b_chunk, b_bounds = _shard_packed(b, n_shards, tile_n)

    # worklists per (device k, ring step s): device k holds b-shard
    # (k + s) % n at step s (ppermute shifts shards by one each step)
    from ..ops.engine import worklist_from_keys

    delta = 1 if (spec.indels and spec.differences == 1) else 0
    lists = {}
    wmax = 1
    for k in range(n_shards):
        alo, ahi = a_bounds[k]
        for s in range(n_shards):
            kb = (k + s) % n_shards
            blo, bhi = b_bounds[kb]
            wl = worklist_from_keys(
                a_stacked["key"][k], ahi - alo,
                b_stacked["key"][kb], bhi - blo,
                delta, tile_m, tile_n,
            )
            lists[(k, s)] = wl
            wmax = max(wmax, len(wl))
    work = np.zeros((n_shards, n_shards, wmax, 2), dtype=np.int32)
    work[:, :, :, 0] = a_chunk - tile_m  # dummy: the shard's pad tile
    work[:, :, :, 1] = b_chunk - tile_n
    for (k, s), wl in lists.items():
        if len(wl):
            work[k, s, : len(wl)] = wl

    # f32 exactness guard: the ring accumulates all n_shards steps into
    # one f32 accumulator inside a single jit, which cannot be chunked
    # without redoing the permute schedule — when per-cell partials
    # could cross 2^24, delegate to the sharded path, whose chunked
    # guard preserves exactness (the ring is the memory-optimised
    # variant; exactness wins when the two conflict).
    import os as _os

    if _os.environ.get("COMPAIRR_DENSE_EXACT", "1") != "0":
        nrep1 = max(db1.repertoire_count, 1)
        nrep2 = max(db2.repertoire_count, 1)
        stats_a_k = []
        stats_b_k = []
        for k in range(n_shards):
            alo, ahi = a_bounds[k]
            blo, bhi = b_bounds[k]
            stats_a_k.append(_block_rep_stats(
                a.rep[alo:ahi], a.counts[alo:ahi], ahi - alo, tile_m,
                a_chunk // tile_m, nrep1,
            ))
            stats_b_k.append(_block_rep_stats(
                b.rep[blo:bhi], b.counts[blo:bhi], bhi - blo, tile_n,
                b_chunk // tile_n, nrep2,
            ))
        total = 0.0
        applicable = True
        for (k, s), wl in lists.items():
            if len(wl) == 0:
                continue
            bd = _tile_exact_bounds(
                wl, stats_a_k[k], stats_b_k[(k + s) % n_shards],
                tile_m, tile_n, score_int, ignore_counts,
            )
            if bd is None:
                applicable = False
                break
            total += float(bd.sum())
        if applicable and total >= _F32_EXACT_LIMIT:
            return dense_matrix_sharded(
                db1, db2, spec, score_int, ignore_counts,
                devices, tile_m, tile_n,
            )

    r1p = _round_up(max(db1.repertoire_count, 1), 8)
    r2p = _round_up(max(db2.repertoire_count, 1), 128)
    spec_kw = dict(
        differences=spec.differences,
        indels=spec.indels and spec.differences == 1,
        ignore_genes=spec.ignore_genes,
    )
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def per_shard(a_stack, b_stack, starts):
        a_args = tuple(x[0] for x in a_stack)
        b_args = tuple(x[0] for x in b_stack)
        starts = starts[0]  # [n_steps, wmax, 2]

        def ring_step(s, carry):
            acc, b_cur = carry

            def tile_step(acc2, st):
                contrib = dense_tile_contrib(
                    a_args, b_cur, st[0], st[1],
                    spec_kw=spec_kw, score_int=score_int,
                    ignore_counts=ignore_counts, r1p=r1p, r2p=r2p,
                    tile_m=tile_m, tile_n=tile_n,
                )
                return acc2 + contrib, None

            sts = lax.dynamic_index_in_dim(starts, s, keepdims=False)
            acc, _ = lax.scan(tile_step, acc, (sts[:, 0], sts[:, 1]))
            # rotate the set-2 shard to the next device
            b_next = tuple(
                lax.ppermute(x, "shard", perm) for x in b_cur
            )
            return acc, b_next

        zeros = jnp.zeros((r1p, r2p), dtype=jnp.float32)
        if hasattr(lax, "pcast"):
            acc0 = lax.pcast(zeros, "shard", to="varying")
        else:  # pragma: no cover - older jax
            acc0 = lax.pvary(zeros, "shard")
        acc, _ = lax.fori_loop(
            0, n_shards, ring_step, (acc0, b_args)
        )
        return lax.psum(acc, "shard")

    keys = ("seqs", "rseqs", "lengths", "v", "j", "rep", "counts")
    a_stack = tuple(
        _global_put(mesh, P("shard"), a_stacked[k]) for k in keys
    )
    b_stack = tuple(
        _global_put(mesh, P("shard"), b_stacked[k]) for k in keys
    )
    fn = jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(
                tuple(P("shard") for _ in a_stack),
                tuple(P("shard") for _ in b_stack),
                P("shard"),
            ),
            out_specs=P(),
        )
    )
    acc = np.asarray(fn(a_stack, b_stack, _global_put(mesh, P("shard"), work)))
    return acc[: db1.repertoire_count, : db2.repertoire_count].astype(
        np.float64
    )
