"""Weak-scaling harness over a virtual device mesh (SURVEY §7 step 9).

Weak scaling: each device gets a constant per-device workload, so
ideal scaling keeps wall-clock flat as devices are added. Set 1 is k
concatenated copies of one base block (identical per-shard rows ->
identical per-shard worklists by construction); set 2 is that base
block, so matched pairs and the matrix checksum scale exactly
linearly with k — a nonzero-output workload, not an empty worklist.

Runs the sharded dense overlap (replicated set 2, psum merge) and the
ring variant (set 2 sharded + ppermute) on 1..N devices of the
virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N).

Two efficiencies are reported:
  efficiency       = t(1) / t(k)      — the real-hardware definition.
  core_normalized  = k * t(1) / t(k)  — honest on THIS host: all k
    virtual "devices" share one physical core, so even a perfectly
    scaling SPMD program serializes to k * t(1); values near 1.0 mean
    the collectives/padding add little beyond that serialization.
On real chips (one core of silicon per device) `efficiency` is the
number to quote; the virtual mesh can only validate the program and
bound the non-compute overhead via `core_normalized`.

Usage:
  env JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python scripts/weak_scaling.py [--per-device 20000] [--mode ring]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def tile_db(base, k: int):
    """k stacked copies of a SeqDB (weak-scaling workload builder)."""
    if k == 1:
        return base
    # array fields below are the complete per-row set for this
    # harness; a native-parsed db would also carry row_hash, which
    # this builder does not tile — reject it rather than return a
    # stale N-length hash array on a k*N-row db
    assert base.row_hash is None, "tile_db does not tile row_hash"
    return dataclasses.replace(
        base,
        seqs=np.tile(base.seqs, (k, 1)),
        lengths=np.tile(base.lengths, k),
        counts=np.tile(base.counts, k),
        rep_no=np.tile(base.rep_no, k),
        v_no=np.tile(base.v_no, k),
        j_no=np.tile(base.j_no, k),
        sequence_ids=list(base.sequence_ids) * k,
        keep=list(base.keep) * k,
        residues_count=base.residues_count * k,
        total_dup_count=base.total_dup_count * k,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=20_000)
    ap.add_argument("--mode", choices=["sharded", "ring"],
                    default="sharded")
    args = ap.parse_args()

    import jax

    from bench import synth_arrays
    from compairr_tpu.constants import SCORE_PRODUCT
    from compairr_tpu.ops.engine import MatchSpec
    from compairr_tpu.parallel.mesh import (
        dense_matrix_ring,
        dense_matrix_sharded,
    )

    devices = jax.devices()
    nmax = len(devices)
    spec = MatchSpec(differences=1, indels=False, ignore_genes=False)
    run = dense_matrix_ring if args.mode == "ring" else dense_matrix_sharded

    base = synth_arrays(args.per_device, n_reps=12, n_v=16, n_j=6, seed=76)
    results = []
    t1 = None
    counts = [1]
    k = 2
    while k <= nmax:
        counts.append(k)
        k *= 2
    from compairr_tpu.parallel import mesh as mesh_mod

    c1 = None
    for ndev in counts:
        d1 = tile_db(base, ndev)
        devs = devices[:ndev]
        # warm (compile) then measure
        run(d1, base, spec, SCORE_PRODUCT, False, devices=devs)
        best = float("inf")
        best_stats = {}
        for _ in range(3):
            t0 = time.perf_counter()
            m = run(d1, base, spec, SCORE_PRODUCT, False, devices=devs)
            w = time.perf_counter() - t0
            if w < best:
                best, best_stats = w, dict(mesh_mod.LAST_STATS)
        if t1 is None:
            t1 = best
            c1 = best_stats.get("compute_s")
        core_norm = ndev * t1 / best
        if core_norm > ndev:
            # t(k) < t(1) on a shared core is a measurement anomaly
            # (host noise); surface it instead of silently clamping
            print(
                f"WARNING: core_normalized {core_norm:.2f} > "
                f"{ndev} (t({ndev}) < t(1)) — noisy measurement",
                file=sys.stderr,
            )
        r = dict(devices=ndev, rows1=d1.n, wall_s=best,
                 efficiency=t1 / best,
                 core_normalized=core_norm,
                 checksum=float(m.sum()))
        # Overhead attribution (sharded mode fills mesh.LAST_STATS):
        # pack/shard/put are host-serial prep here but per-host
        # parallel on a real multi-host mesh (COMPAIRR_INPUT_SHARD),
        # so compute_core_normalized — the SPMD program itself — is
        # the honest weak-scaling figure; pad_fraction reports how
        # much of the worklist is padding quantisation.
        if best_stats:
            cs = best_stats.get("compute_s")
            r.update(
                compute_s=cs,
                prep_s=best - cs if cs is not None else None,
                pack_s=best_stats.get("pack_s"),
                shard_s=best_stats.get("shard_s"),
                put_s=best_stats.get("put_s"),
                real_tiles=best_stats.get("real_tiles"),
                padded_tiles_per_shard=best_stats.get(
                    "padded_tiles_per_shard"
                ),
                pad_fraction=best_stats.get("pad_fraction"),
            )
            if cs is not None and c1:
                r["compute_core_normalized"] = ndev * c1 / cs
        results.append(r)
        print(json.dumps(results[-1]))

    # The workload construction guarantees exact linearity, and the
    # dense engine's matrices are exact-integer f64 (the f32 exactness
    # guard chunks anything that could round), so equality must be
    # bit-exact — if a future dtype change breaks this, fail loudly.
    assert all(
        r["checksum"] == r["devices"] * results[0]["checksum"]
        for r in results
    ), "matrix checksum must scale exactly linearly (exact-integer f64)"

    print(
        json.dumps(
            dict(
                metric=f"weak-scaling ({args.mode}, virtual "
                       f"{nmax}-device mesh)",
                per_device_rows=args.per_device,
                efficiency_at_max=results[-1]["efficiency"],
                core_normalized_at_max=results[-1]["core_normalized"],
                compute_core_normalized_at_max=results[-1].get(
                    "compute_core_normalized"
                ),
                results=results,
            )
        )
    )


if __name__ == "__main__":
    main()
