"""Smoke test of the GPU path, for a machine with an NVIDIA card.

    python chip_smoke.py                 # one card, phases 1-7
    python chip_smoke.py --four-cards    # four cards: multi-device phases only
    python chip_smoke.py --rows N        # cut the Keck-scale phase (>= 4M)

One card (the CLI runs go through cli.main in this process, which is
the only one holding the card; the pytest child of phase 7 runs first,
before this process touches JAX):
  1. the card (nvidia-smi) and jax.devices(); fails unless JAX runs on
     a GPU
  2. the reference's own integration test, `-m seta setb -d 1 -i` on
     tests/data, byte-identical to expected.tsv through the tile route
  3. each Triton kernel class (equal-key, mixed, indel-only; exclude
     self on and off; d=1 and d=2) against engine._count_fn /
     _extract_fn on worklists of a 1M-row Keck-shaped set: exact
  4. `-m -d 1 -i` on a 24,205,557-row Keck-shaped self-comparison
     (tile route), byte-identical to the host one-indel pigeonhole
     (COMPAIRR_PIGEONHOLE=all); wall, phase laps and peak device bytes
  5. `-m -d 2` on the 1M set, device tile route (COMPAIRR_PIGEONHOLE=0)
     byte-identical to the default host pigeonhole
  6. `COMPAIRR_ENGINE=dense -m -d 1` on the 1M set, byte-identical to
     the sparse default
  7. the `gpu`-marked tests
Four cards: the Keck-scale `-m -d 1 -i` run on one device
(COMPAIRR_DEVICES=1) byte-identical to the run split over all four,
and dense_matrix_sharded / dense_matrix_ring equal to dense_matrix.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}, printed only
when every phase passed; any failure exits nonzero without it.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KECK_ROWS = 24_205_557
MIN_ROWS = 4_000_000
PARITY_ROWS = 1_000_000


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_native() -> None:
    r = subprocess.run(
        ["make", "-C", os.path.join(REPO, "native")],
        capture_output=True, text=True,
    )
    if r.returncode:
        fail(f"make -C native: {r.stdout[-2000:]}{r.stderr[-2000:]}")


def card_lines() -> list:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
    except (OSError, subprocess.CalledProcessError) as e:
        fail(f"nvidia-smi: {e}")
    return r.stdout.strip().splitlines()


def require_gpu(count: int) -> list:
    """Phase 1's gate: JAX must run on `count` GPUs."""
    import jax

    devs = jax.devices()
    say(f"jax.devices(): {devs}")
    if devs[0].platform != "gpu":
        fail(f"JAX runs on {devs[0].platform}, not a GPU")
    if len(devs) < count:
        fail(f"{count} GPUs needed, {len(devs)} visible")
    return devs[:count]


def run_gpu_tests() -> tuple:
    """The `gpu`-marked tests, in a child that owns the card while it
    runs (before this process opens it)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, COMPAIRR_TEST_GPU="1"),
    )
    lines = r.stdout.strip().splitlines()
    return r.returncode, lines[-1] if lines else "", time.perf_counter() - t0


@contextlib.contextmanager
def env(**kv):
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: v for k, v in kv.items() if v is not None})
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(args: list, work: str, name: str, **env_kv) -> tuple:
    """cli.main in this process; returns (output bytes, wall seconds,
    route, the [timing] lines it printed)."""
    from compairr_tpu import cli
    from compairr_tpu.ops import engine

    out = os.path.join(work, f"{name}.tsv")
    err = io.StringIO()
    engine.LAST_ROUTE = None
    with env(**env_kv), contextlib.redirect_stderr(err):
        t0 = time.perf_counter()
        rc = cli.main(
            [*args, "-o", out, "-l", os.path.join(work, f"{name}.log")]
        )
        wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{name}: exit code {rc}: {err.getvalue()[-2000:]}")
    with open(out, "rb") as f:
        data = f.read()
    timing = [ln for ln in err.getvalue().splitlines() if "[timing]" in ln]
    return data, wall, engine.LAST_ROUTE, timing


def keck_db(rows: int, seed: int = 1):
    import bench

    db = bench.synth_arrays(rows, n_reps=120, n_v=50, n_j=13, seed=seed)
    bench._plant_near_dups(db, db, 0.01, seed=seed + 6)
    return db


def phase_golden(work: str) -> None:
    data = os.path.join(REPO, "tests", "data")
    out, _wall, route, _ = run_cli(
        ["-m", os.path.join(data, "seta.tsv"),
         os.path.join(data, "setb.tsv"), "-d", "1", "-i"],
        work, "golden",
    )
    with open(os.path.join(data, "expected.tsv"), "rb") as f:
        want = f.read()
    if out != want or route != "tiles":
        fail(f"golden: route {route}, output {out!r} != {want!r}")
    say("phase 2 golden -m seta setb -d 1 -i: byte-identical to "
        "expected.tsv, route tiles")


def phase_kernel_parity(db, tag: str) -> None:
    """Each kernel class against the plain XLA scan on the worklists of
    a Keck-shaped set, exact (integer outputs)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from compairr_tpu.ops import engine, gpu_kernels as G
    from compairr_tpu.ops.derive import device_rows_raw

    T = G.TILE
    lmax = int(db.longest)
    order, key, npad = engine.pack_keys(db, T, True)
    p = engine.pack_set(db, lmax, T, True)
    xla = tuple(
        jax.device_put(x)
        for x in (p.seqs, p.rseqs, p.lengths, p.v, p.j, p.orig)
    )
    rows = device_rows_raw(db, order, key, npad, lmax, indels=True)
    dummy = np.array([npad - T, npad - T], np.int32)
    for d, indels in ((1, True), (1, False), (2, False)):
        delta = 1 if indels else 0
        work = engine.worklist_from_keys(key, db.n, key, db.n, delta, T, T)
        he, hp = engine.classify_worklist(work, key, db.n, key, db.n, T, T)
        streams = (
            [("equal", work[he & ~hp], False, False),
             ("mixed", work[he & hp], True, False),
             ("indel-only", work[~he & hp], True, True)]
            if indels else [("equal", work[he], False, False)]
        )
        for xself in (True, False):
            spec = engine.MatchSpec(d, indels, False, xself)
            for name, w, s_ind, s_io in streams:
                w = engine.order_colmajor(w)
                kw = dict(differences=d, indels=s_ind, indel_only=s_io,
                          exclude_self=xself)
                t0 = time.perf_counter()
                got = np.concatenate([
                    np.asarray(x) for x in G.count_tiles(rows, rows, w, **kw)
                ])[: len(w)]
                kt = time.perf_counter() - t0
                wp = G._padded(w, G.launch_len(len(w)), dummy)
                t0 = time.perf_counter()
                ref = np.asarray(
                    engine._count_fn(spec, T, T, indels_ov=s_ind,
                                     indel_only=s_io)(
                        *xla, *xla, jnp.asarray(wp))
                )[: len(w)]
                xt = time.perf_counter() - t0
                if not np.array_equal(got, ref):
                    fail(f"count d={d} {name} xself={xself}: "
                         f"{int((got != ref).sum())} tiles differ")
                hit = w[ref > 0][:4096]
                slab = G._padded(hit, G.launch_len(len(hit)), dummy)
                k = 1 << max(12, int(ref[ref > 0][:4096].sum() - 1)
                             .bit_length())
                ki, kv, kn = jax.device_get(
                    G.extract_tiles(rows, rows, slab, k=k, **kw)
                )
                xi, xv, xn = jax.device_get(
                    engine._extract_fn(spec, T, T, len(slab), k,
                                       indels_ov=s_ind, indel_only=s_io)(
                        *xla, *xla, jnp.asarray(slab))
                )
                n = int(xn)
                if not (int(kn) == n and np.array_equal(ki[:n], xi[:n])
                        and np.array_equal(kv[:n], xv[:n].astype(np.uint32))):
                    fail(f"extract d={d} {name} xself={xself}: words differ")
                say(f"phase 3 d={d} {name} exclude_self={xself}: count "
                    f"{len(w)} tiles exact ({int(ref.sum())} matches; "
                    f"kernel {kt:.3f}s incl. compile, XLA {xt:.3f}s), "
                    f"extract {len(hit)} tiles exact ({n} words) {tag}")
    for d, s_ind, s_io in ((1, False, False), (1, True, False),
                           (1, True, True), (2, False, False)):
        kw = dict(differences=d, indels=s_ind, indel_only=s_io,
                  exclude_self=True, lmax=lmax, interpret=False)
        n = 1 << 15
        args = [jax.ShapeDtypeStruct((n,), jnp.int32)] * 2 + [
            jax.ShapeDtypeStruct(x.shape, x.dtype)
            for x in G._set_args(rows, s_ind)
        ] * 2
        cnt = jax.jit(G._tiles_call(n, words=False, **kw)).lower(*args)
        ext = G._extract_fn(n, 1 << 20, **kw).lower(*args)
        for label, low in (("count", cnt), ("extract", ext)):
            say(f"phase 3 memory_analysis {label} d={d} indels={s_ind} "
                f"indel_only={s_io}: {low.compile().memory_analysis()}")


def phase_keck(rows: int, work: str, tag: str, threads: str) -> None:
    import jax

    import bench

    db = keck_db(rows)
    tsv = bench.write_airr_tsv(os.path.join(work, "keck.tsv"), db)
    del db
    args = ["-m", tsv, "-d", "1", "-i", "-t", threads]
    dev, wall, route, timing = run_cli(args, work, "keck_dev",
                                       COMPAIRR_TIMING="1")
    if route != "tiles":
        fail(f"keck: route {route}, not tiles")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(f"phase 4 -m -d 1 -i {rows} rows: tile route wall {wall:.2f}s, "
        f"peak_bytes_in_use {peak} {tag}")
    for ln in timing:
        say(f"phase 4 laps {ln} {tag}")
    host, hwall, hroute, _ = run_cli(args, work, "keck_host",
                                     COMPAIRR_PIGEONHOLE="all")
    if hroute != "pigeonhole_indel" or host != dev:
        fail(f"keck: host pigeonhole ({hroute}) output differs")
    say(f"phase 4 byte-identical to the host one-indel pigeonhole "
        f"(wall {hwall:.2f}s) {tag}")


def phase_d2_and_dense(tsv: str, work: str, tag: str) -> None:
    args = ["-m", tsv, "-d", "2"]
    dev, wall, route, _ = run_cli(args, work, "d2_dev",
                                  COMPAIRR_PIGEONHOLE="0")
    host, hwall, hroute, _ = run_cli(args, work, "d2_host")
    if route != "tiles" or host != dev:
        fail(f"d=2: tile route ({route}) differs from host ({hroute})")
    say(f"phase 5 -m -d 2 {PARITY_ROWS} rows: tile route {wall:.2f}s "
        f"byte-identical to {hroute} {hwall:.2f}s {tag}")
    args = ["-m", tsv, "-d", "1"]
    dense, wall, _, _ = run_cli(args, work, "d1_dense",
                                COMPAIRR_ENGINE="dense")
    sparse, swall, sroute, _ = run_cli(args, work, "d1_sparse")
    if dense != sparse:
        fail("COMPAIRR_ENGINE=dense output differs from the sparse path")
    say(f"phase 6 COMPAIRR_ENGINE=dense -m -d 1 {PARITY_ROWS} rows: "
        f"{wall:.2f}s byte-identical to sparse ({sroute}) {swall:.2f}s "
        f"{tag}")


def four_cards(rows: int, work: str, tag: str, threads: str) -> None:
    import jax
    import numpy as np

    import bench
    from compairr_tpu.constants import SCORE_PRODUCT
    from compairr_tpu.ops.engine import MatchSpec, dense_matrix
    from compairr_tpu.parallel.mesh import (
        dense_matrix_ring,
        dense_matrix_sharded,
    )

    db = keck_db(rows)
    tsv = bench.write_airr_tsv(os.path.join(work, "keck.tsv"), db)
    del db
    args = ["-m", tsv, "-d", "1", "-i", "-t", threads]
    one, w1, r1, _ = run_cli(args, work, "one", COMPAIRR_DEVICES="1")
    four, w4, r4, _ = run_cli(args, work, "four", COMPAIRR_DEVICES=None)
    if not (r1 == r4 == "tiles") or one != four:
        fail("-m -d 1 -i differs between 1 and 4 devices")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()]
    say(f"four cards -m -d 1 -i {rows} rows: 1 device {w1:.2f}s, "
        f"4 devices {w4:.2f}s, byte-identical; peak_bytes_in_use per "
        f"device {peaks} {tag}")

    a = keck_db(200_000, seed=11)
    b = keck_db(200_000, seed=21)
    bench._plant_near_dups(a, b, 0.05, seed=13)  # cross-set matches
    for d, indels in ((1, True), (2, False)):
        spec = MatchSpec(d, indels, False)
        t0 = time.perf_counter()
        single = dense_matrix(a, b, spec, SCORE_PRODUCT, False)
        ts = time.perf_counter() - t0
        t0 = time.perf_counter()
        sharded = dense_matrix_sharded(a, b, spec, SCORE_PRODUCT, False)
        tsh = time.perf_counter() - t0
        t0 = time.perf_counter()
        ring = dense_matrix_ring(a, b, spec, SCORE_PRODUCT, False)
        tr = time.perf_counter() - t0
        if not (np.array_equal(single, sharded)
                and np.array_equal(single, ring)):
            fail(f"dense d={d}: sharded/ring differ from dense_matrix")
        say(f"four cards dense d={d} indels={indels} 200k x 200k: "
            f"sharded {tsh:.2f}s and ring {tr:.2f}s equal dense_matrix "
            f"{ts:.2f}s (sum {single.sum():.0f}) {tag}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--rows", type=int, default=KECK_ROWS)
    opts = ap.parse_args()
    if opts.rows < MIN_ROWS:
        fail(f"--rows below {MIN_ROWS}")
    if opts.rows != KECK_ROWS:
        say(f"Keck-scale phase cut to {opts.rows} rows (from {KECK_ROWS})")

    build_native()
    cards = card_lines()
    say(f"phase 1 card: {cards}")
    count = 4 if opts.four_cards else 1
    tests = None if opts.four_cards else run_gpu_tests()
    devs = require_gpu(count)
    tag = f"[{cards[0]}]"
    threads = str(min(os.cpu_count() or 1, 64))
    sys.path.insert(0, REPO)
    work = os.path.join(REPO, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        if opts.four_cards:
            four_cards(opts.rows, work, tag, threads)
        else:
            import bench

            phase_golden(work)
            db = keck_db(PARITY_ROWS, seed=31)
            phase_kernel_parity(db, tag)
            tsv = bench.write_airr_tsv(os.path.join(work, "m1.tsv"), db)
            del db
            phase_keck(opts.rows, work, tag, threads)
            phase_d2_and_dense(tsv, work, tag)
            rc, summary, secs = tests
            if rc != 0 or "passed" not in summary or "skipped" in summary:
                fail(f"gpu-marked tests: exit {rc}: {summary}")
            say(f"phase 7 gpu-marked tests (run first): {summary} "
                f"({secs:.1f}s) {tag}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(cards[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()
