#!/usr/bin/env python
"""Large-separator distributed LORASC demo.

Builds and solves with the GENERAL distributed LORASC driver
(parallel/lorasc_driver.py) on a problem whose separator exceeds 17k rows
— the regime where round-2 materialized a replicated dense ng² inverse
(2.4 GB here). The round-3 banded separator factorization (RCM block-
banded Cholesky, the reference's MUMPS role — mumps_solver.c:83-90 +
lorasc.c:248-257) keeps memory at n·band and the deflation path intact.

Usage: python examples/demo_large_separator.py [nel] [nshards]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu.solvers import ECGOptions

    nel = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    nsh = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    a = elasticity3d(nel, nel, nel)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])
    opts = ECGOptions(t=4, tol=1e-5, maxiter=2000, variant="odir_fused")
    t0 = time.time()
    s = DistributedLorascECG.build(a, nshards=nsh, opts=opts,
                                   dtype=np.float64)
    build_s = time.time() - t0
    print(f"built: n={a.shape[0]} ngroups={s.ngroups} ng_max={s.ng_max} "
          f"(separator {s.ng_max * s.ngroups} padded rows, banded — no "
          f"ng^2 dense) deflated={s.deflated} build={build_s:.0f}s",
          flush=True)
    t0 = time.time()
    x, info = s.solve(b)
    solve_s = time.time() - t0
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    print(f"solved: iters={info['iters']} relres={relres:.3e} "
          f"solve={solve_s:.0f}s", flush=True)
    assert relres < 1e-4


if __name__ == "__main__":
    main()
