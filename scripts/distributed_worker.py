"""One process of a multi-process jax.distributed run (CPU backend).

Launched N times (by tests/test_distributed.py and
__graft_entry__.dryrun_multichip) with a shared local coordinator;
the processes form ONE global device mesh (each contributes its
xla_force_host_platform_device_count virtual CPU devices) and run the
sharded + ring overlap matrices over it. Every process saves its
replicated result; the launcher asserts all copies equal the
single-process matrix.

This executes the layer the reference cannot have (it is a
single-machine pthreads tool, SURVEY.md §5.8): a real
jax.distributed.initialize + cross-process collective (psum/ppermute)
run, standing in for a multi-host cluster without the hardware.

Usage: distributed_worker.py <pid> <nproc> <coordinator> <outdir>
"""

import os
import sys


def launch(nproc: int = 2, local_devices: int = 4, timeout: int = 300):
    """Run the full multi-process check: spawn `nproc` workers with
    `local_devices` virtual CPU devices each, wait, and return
    {pid: (sharded, ring)} matrices loaded from the workers' outputs.
    Raises on any worker failure."""
    import socket
    import subprocess
    import tempfile

    import numpy as np

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"

    here = os.path.abspath(__file__)
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={local_devices}"
        ),
    )
    # a stale distributed client in THIS process must not leak into
    # workers; they initialize their own
    env.pop("JAX_COORDINATOR_ADDRESS", None)

    with tempfile.TemporaryDirectory() as td:
        procs = [
            subprocess.Popen(
                [sys.executable, here, str(pid), str(nproc), coord, td],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                env=env,
            )
            for pid in range(nproc)
        ]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append(out)
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"distributed worker failed (rc={p.returncode}):\n"
                    + out[-4000:]
                )
        return {
            pid: (
                np.load(os.path.join(td, f"sharded_{pid}.npy")),
                np.load(os.path.join(td, f"ring_{pid}.npy")),
            )
            for pid in range(nproc)
        }


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coord = sys.argv[3]
    outdir = sys.argv[4]

    # CPU backend with virtual devices; the launcher sets
    # XLA_FLAGS=--xla_force_host_platform_device_count=<k>
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )

    import numpy as np

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from __graft_entry__ import _dryrun_dbs
    from compairr_tpu.constants import SCORE_PRODUCT
    from compairr_tpu.parallel.mesh import (
        dense_matrix_ring,
        dense_matrix_sharded,
    )

    assert jax.process_count() == nproc, jax.process_count()
    local = len(jax.local_devices())
    total = jax.device_count()
    assert total == nproc * local, (total, nproc, local)

    d1, d2, spec = _dryrun_dbs()
    sharded = dense_matrix_sharded(
        d1, d2, spec, SCORE_PRODUCT, False, devices=jax.devices()
    )
    ring = dense_matrix_ring(
        d1, d2, spec, SCORE_PRODUCT, False, devices=jax.devices()
    )
    np.save(os.path.join(outdir, f"sharded_{pid}.npy"), sharded)
    np.save(os.path.join(outdir, f"ring_{pid}.npy"), ring)
    print(
        f"distributed_worker {pid}/{nproc}: {total} global devices "
        f"({local} local), sum={sharded.sum():.0f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
