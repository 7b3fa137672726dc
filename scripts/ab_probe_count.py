"""Triton kernels vs the plain XLA scan, on a GPU, at Keck scale.

Times the sparse engine's count and extract phases the way a Keck
`-m -d 1 -i` self-comparison runs them (24,205,557 rows, 120
repertoires, 50 V / 13 J genes, CDR3 9-22 aa, 1% planted near
duplicates; bench.py's generators), once through the Triton kernels
(ops/gpu_kernels.py) and once through engine._count_fn /
engine._extract_fn. The XLA scan runs one tile per step, so it is timed
on a leading sample of each worklist stream and its per-tile time is
reported beside the kernel's; both are checked equal on that sample.
The d=2 worklist gets the same treatment, and the XLA dense path
(engine.dense_matrix) is timed on a 1M x 1M two-set d=2 workload.

    python scripts/ab_probe_count.py [--rows N] [--sample TILES]
                                     [--json PATH]

Prints one line per measurement with the card's name and power limit
(and writes them all to PATH with --json). Exits nonzero without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (synth_arrays, _plant_near_dups)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def best_of(fn, reps):
    out, best = None, float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=24_205_557)
    ap.add_argument("--sample", type=int, default=1 << 14)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", help="also write the results here")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from compairr_tpu.constants import SCORE_PRODUCT
    from compairr_tpu.ops import engine, gpu_kernels as G
    from compairr_tpu.ops.derive import device_rows_raw

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a CUDA GPU, found {dev.platform}")
    tag = f"[{card()}]"
    results = dict(card=card(), device_kind=dev.device_kind, rows=args.rows)

    def report(name, **kv):
        results[name] = kv
        print(name, json.dumps(kv), tag, flush=True)

    T = G.TILE
    db = bench.synth_arrays(args.rows, n_reps=120, n_v=50, n_j=13, seed=1)
    bench._plant_near_dups(db, db, 0.01, seed=7)
    lmax = int(db.longest)
    order, key, npad = engine.pack_keys(db, T, True)
    rows = device_rows_raw(db, order, key, npad, lmax, indels=True)
    p = engine.pack_set(db, lmax, T, True)
    xla_args = tuple(
        jax.device_put(x)
        for x in (p.seqs, p.rseqs, p.lengths, p.v, p.j, p.orig)
    )
    del p
    dummy = np.array([npad - T, npad - T], np.int32)

    def streams(delta):
        work = engine.worklist_from_keys(key, db.n, key, db.n, delta, T, T)
        he, hp = engine.classify_worklist(work, key, db.n, key, db.n, T, T)
        if delta:
            out = [("equal", work[he & ~hp], False, False),
                   ("mixed", work[he & hp], True, False),
                   ("indel_only", work[~he & hp], True, True)]
        else:
            out = [("equal", work[he], False, False)]
        return [(n, engine.order_colmajor(w), i, o) for n, w, i, o in out]

    def kernel_counts(w, d, ind, io):
        parts = G.count_tiles(rows, rows, w, differences=d, indels=ind,
                              indel_only=io, exclude_self=True)
        return np.concatenate([np.asarray(x) for x in parts])[: len(w)]

    def xla_counts(w, spec, ind, io):
        wp = G._padded(w, G.launch_len(len(w)), dummy)
        fn = engine._count_fn(spec, T, T, indels_ov=ind, indel_only=io)
        return np.asarray(fn(*xla_args, *xla_args, jnp.asarray(wp)))[
            : len(w)
        ]

    for d, delta in ((1, 1), (2, 0)):
        spec = engine.MatchSpec(d, delta == 1, False, True)
        for name, w, ind, io in streams(delta):
            if not len(w):
                continue
            sample = w[: args.sample]
            ref_t, ref = best_of(
                lambda: xla_counts(sample, spec, ind, io), 2
            )
            kernel_counts(sample, d, ind, io)  # compile
            got = kernel_counts(sample, d, ind, io)
            assert np.array_equal(got, ref), (d, name)
            full_t, full = best_of(
                lambda: kernel_counts(w, d, ind, io), args.reps
            )
            report(
                f"count d={d} {name}",
                tiles=int(len(w)), kernel_s=full_t,
                kernel_us_per_tile=full_t / len(w) * 1e6,
                xla_sample_tiles=int(len(sample)), xla_sample_s=ref_t,
                xla_us_per_tile=ref_t / len(sample) * 1e6,
                matches=int(full.sum()),
            )
            # extraction of the matched tiles (the phase-2 input)
            hit = w[kernel_counts(w, d, ind, io) > 0][: args.sample]
            if not len(hit):
                continue
            slab = G._padded(hit, G.launch_len(len(hit)), dummy)
            k = 1 << max(12, int(len(hit) * T - 1).bit_length())
            k = min(k, 1 << 22)

            def kern():
                r = G.extract_tiles(rows, rows, slab, differences=d,
                                    indels=ind, indel_only=io,
                                    exclude_self=True, k=k)
                return jax.device_get(r)

            kern()
            kt, kr = best_of(kern, args.reps)
            xfn = engine._extract_fn(spec, T, T, len(slab), k,
                                     indels_ov=ind, indel_only=io)
            xt, xr = best_of(
                lambda: jax.device_get(
                    xfn(*xla_args, *xla_args, jnp.asarray(slab))
                ),
                2,
            )
            n = int(xr[2])
            assert int(kr[2]) == n
            assert np.array_equal(kr[0][:n], xr[0][:n])
            assert np.array_equal(kr[1][:n], xr[1][:n].astype(np.uint32))
            report(
                f"extract d={d} {name}", tiles=int(len(hit)),
                slab=int(len(slab)), kernel_s=kt, xla_s=xt, words=n,
            )

    # memory analysis of each kernel class, as compiled for the card
    for d, ind, io in ((1, False, False), (1, True, False), (1, True, True),
                       (2, False, False)):
        for words in (False, True):
            call = G._tiles_call(
                1 << 15, differences=d, indels=ind, indel_only=io,
                exclude_self=True, lmax=lmax, words=words,
                interpret=False,
            )
            sds = [jax.ShapeDtypeStruct((1 << 15,), jnp.int32)] * 2 + [
                jax.ShapeDtypeStruct(x.shape, x.dtype)
                for x in G._set_args(rows, ind)
            ] * 2
            ma = jax.jit(call).lower(*sds).compile().memory_analysis()
            print(f"memory_analysis {'extract' if words else 'count'} "
                  f"d={d} indels={ind} indel_only={io}: {ma}", flush=True)
    del rows, xla_args

    # the XLA dense path on a 1M x 1M two-set d=2 workload
    nk = 1_000_000
    d1 = bench.synth_arrays(nk, n_reps=60, n_v=48, n_j=13, seed=11)
    d2 = bench.synth_arrays(nk, n_reps=60, n_v=48, n_j=13, seed=12)
    bench._plant_near_dups(d1, d2, 0.01, seed=13)
    dspec = engine.MatchSpec(2, False, False)
    t0 = time.perf_counter()
    m = engine.dense_matrix(d1, d2, dspec, SCORE_PRODUCT, False)
    first = time.perf_counter() - t0
    dt, m2 = best_of(
        lambda: engine.dense_matrix(d1, d2, dspec, SCORE_PRODUCT, False), 2
    )
    assert np.array_equal(m, m2)
    a = engine.pack_set(d1, int(max(d1.longest, d2.longest)), T, True)
    b = engine.pack_set(d2, int(max(d1.longest, d2.longest)), T, True)
    tiles = len(engine.build_worklist(a, b, dspec, T, T))
    report("dense xla 1Mx1M d=2", wall_s=dt, first_call_s=first,
           tiles=int(tiles), checksum=float(m.sum()))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
