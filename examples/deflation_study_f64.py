#!/usr/bin/env python
"""f64 deflation study at benchmark scale.

Separates ALGORITHM from f32 PRECISION in the remaining het-LORASC
iteration gap (f32: ~166-169 iters at defl≈256-capped vs the
reference's ~102-at-16-procs regime, BASELINE.md Table 4): runs the
scalable LORASC build + solve in float64 on the CPU backend at the
benchmark size and sweeps max_deflation, printing one row per config:

    defl_requested  defl_kept  iters  relres  build_s  solve_s

Reference context: the reference runs PARPACK with nev fixed at 150 and
deflates all pairs with lambda <= 1e-2 (prealps_manual.pdf section 5.2.2).

Usage (CPU f64; hours-scale, run in background):
    python examples/deflation_study_f64.py [nel] [defl1,defl2,...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
    from prealps_tpu.solvers import ECGOptions

    nel = int(sys.argv[1]) if len(sys.argv) > 1 else 36
    defls = ([int(x) for x in sys.argv[2].split(",")]
             if len(sys.argv) > 2 else [64, 128, 256, 512])
    t0 = time.time()
    a = elasticity3d(nel, nel, nel, heterogeneous=True)
    n = a.shape[0]
    print(f"# n={n} nnz={a.nnz} heterogeneous f64 cpu ({time.time()-t0:.0f}s)",
          flush=True)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)

    print("# defl_req  defl_kept  iters  relres     build_s  solve_s",
          flush=True)
    for defl in defls:
        opts = ECGOptions(t=12, tol=1e-5, maxiter=3000,
                          variant="odir_fused", layout="tbn")
        t0 = time.time()
        s = StencilLorascECG.build(
            a, nparts=8, br=3, grid=(nel + 1, nel + 1, nel), opts=opts,
            dtype=np.float64, max_deflation=defl,
        )
        build_s = time.time() - t0
        t0 = time.time()
        x, info = s.solve(b)
        solve_s = time.time() - t0
        relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
        print(f"{defl:9d}  {info['deflated']:9d}  {info['iters']:5d}  "
              f"{relres:.3e}  {build_s:7.1f}  {solve_s:7.1f}", flush=True)


if __name__ == "__main__":
    main()
