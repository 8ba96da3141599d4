#!/usr/bin/env python
"""Multi-process (cross-host analog) launch recipe: the distributed LORASC solver
across N OS processes under `jax.distributed`.

The reference scales across nodes with `mpirun -np N test_lorasc ...`
(reference: README.md:53-59, examples/test_lorasc.c:168); the JAX-native
equivalent is one process per host wired up by `jax.distributed.initialize`.
This script demonstrates the full recipe on one box with CPU devices:

    python examples/multihost_launch.py --nproc 2 --devices-per-proc 4

Parent: picks a free coordinator port, spawns N worker copies of ITSELF.
Worker: initializes the distributed runtime, builds DistributedLorascECG
on the cross-process ("shards","local") mesh — operand globalization is
automatic (parallel/multihost.py globalize_operands) — solves, and checks
the true residual. On a real cluster, run one copy per host with --pid set by
the launcher (or rely on cluster auto-detection and drop the flags).
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# NOTE: tests/_multihost_worker.py (mode "lorasc") runs the same scenario as
# the pytest-launched regression; this example keeps a self-contained copy
# as the user-facing recipe — change them together.


def worker(coord: str, nproc: int, pid: int, devices: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={devices}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.parallel import multihost
    from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu.solvers import ECGOptions

    multihost.initialize(coordinator=coord, num_processes=nproc,
                         process_id=pid)
    ndev = len(jax.devices())

    # every process builds from the same deterministic operator (the
    # reference reads the same .mtx on every rank — operator.c:38)
    a = elasticity3d(6, 5, 5)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])

    solver = DistributedLorascECG.build(
        a, mesh_shape=(ndev // 2, 2),
        opts=ECGOptions(t=2, tol=1e-8, maxiter=2000, variant="odir_fused"),
        exact_schur=False, max_deflation=16, correction="deflate",
    )
    x, info = solver.solve(b)
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    print(f"[proc {pid}/{nproc}] iters={info['iters']} "
          f"deflated={solver.deflated} true_relres={relres:.3e}", flush=True)
    assert relres < 1e-7, relres


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--coord", help=argparse.SUPPRESS)
    ap.add_argument("--pid", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.worker:
        worker(args.coord, args.nproc, args.pid, args.devices_per_proc)
        return 0

    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--coord", coord, "--nproc", str(args.nproc),
             "--pid", str(p), "--devices-per-proc",
             str(args.devices_per_proc)],
            env=env,
        )
        for p in range(args.nproc)
    ]
    rc = 0
    try:
        for p in procs:
            if p.wait(timeout=600) != 0:
                rc = 1
    finally:
        # a dead worker leaves the survivors blocked in collectives — kill
        # the whole set on any failure/timeout (mirrors the test launcher)
        for p in procs:
            if p.poll() is None:
                p.kill()
                rc = 1
    print("ALL_OK" if rc == 0 else f"FAILED rc={rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
