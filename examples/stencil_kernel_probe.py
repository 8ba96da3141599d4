#!/usr/bin/env python
"""Time the stencil SpMM forms at the headline size and the bj2l solve with
each operator, to re-run the kernel decision recorded in PERF.md.

    python examples/stencil_kernel_probe.py            # GPU, n=147,852, t=12
    python examples/stencil_kernel_probe.py --nel 4 --interpret   # CPU check

Forms: the Triton kernel (chunks 64 and 128), the repo's XLA scan form, and
two unrolled XLA forms kept here only for the comparison (f64 and f32
accumulators). Each line gives the median of 20 applies (host clock around
block_until_ready) and the error against scipy's f64 A @ X. With --e2e the
headline bj2l solve runs with the Triton kernel and with the faster XLA
form, in the order Triton, XLA, XLA, Triton, three warm solves each.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from prealps_tpu.config import init_compile_cache
from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.ops import spmm
from prealps_tpu.ops.blockops import f64_traced
from prealps_tpu.ops.formats import csr_to_stencil_bsr_t


def unrolled(blocks_t, offsets, x_ext, halo, acc_dtype):
    """One elementwise chain over the 27 shifted windows (XLA may fuse it
    into a single kernel), accumulating in acc_dtype."""
    _, br, _, nrb = blocks_t.shape
    t = x_ext.shape[0]
    y = [jnp.zeros((t, nrb), acc_dtype) for _ in range(br)]
    for s, off in enumerate(offsets):
        xs = jax.lax.slice_in_dim(x_ext, halo + off, halo + off + nrb, axis=2)
        xs = xs.astype(acc_dtype)
        for m in range(br):
            for k in range(br):
                y[m] = y[m] + blocks_t[s, m, k][None, :].astype(acc_dtype) \
                    * xs[:, k, :]
    return jnp.stack(y, axis=1).astype(x_ext.dtype)


def time_apply(fn, *args, reps=20):
    for _ in range(3):
        fn(*args).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3, min(times) * 1e3, max(times) * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nel", type=int, default=36)
    p.add_argument("--t", type=int, default=12)
    p.add_argument("--interpret", action="store_true",
                   help="run the Triton kernel in interpret mode (CPU)")
    p.add_argument("--e2e", action="store_true",
                   help="also time the bj2l solve with each operator")
    args = p.parse_args(argv)

    init_compile_cache()
    jax.config.update("jax_default_matmul_precision", "highest")
    dev = jax.devices()[0]
    print(f"device {dev.platform} {dev.device_kind}", flush=True)
    if dev.platform == "gpu":
        print("nvidia-smi:", subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
            flush=True)

    nel, t = args.nel, args.t
    a = elasticity3d(nel, nel, nel)
    st = csr_to_stencil_bsr_t(a, br=3, dtype=np.float32)
    offs = tuple(st.offsets)
    halo = max(abs(o) for o in offs)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((a.shape[0], t)).astype(np.float32)
    xt = spmm.panel_to_lane_major(jnp.asarray(x), 3)
    y_ref = a @ x.astype(np.float64)
    bound = 1e-5 * float(np.abs(abs(a) @ np.abs(x.astype(np.float64))).max())
    print(f"n={a.shape[0]} t={t} bound 1e-5*max(|A||X|)={bound:.3e}",
          flush=True)

    forms = {
        "xla_scan_f64acc": spmm.stencil_spmm_xla_ext,
        "xla_unrolled_f64acc": f64_traced(
            lambda b, o, v, h: unrolled(b, o, v, h, jnp.float64)),
        "xla_unrolled_f32acc": (
            lambda b, o, v, h: unrolled(b, o, v, h, jnp.float32)),
    }
    for chunk in (64, 128):
        forms[f"triton_f64acc_c{chunk}"] = (
            lambda b, o, v, h, c=chunk: spmm.stencil_spmm_triton_ext(
                b, o, v, h, chunk=c, interpret=args.interpret))
    ms = {}
    for name, form in forms.items():
        fn = jax.jit(lambda b, v, f=form: f(b, offs,
                                            spmm.attach_wrap_halo(v, halo),
                                            halo))
        y = np.asarray(spmm.panel_from_lane_major(fn(st.blocks_t, xt)),
                       np.float64)
        err = float(np.abs(y - y_ref).max())
        med, lo, hi = time_apply(fn, st.blocks_t, xt)
        ms[name] = med
        print(name, json.dumps(dict(median_ms=med, min_ms=lo, max_ms=hi,
                                    err=err, ok=err <= bound)), flush=True)

    if args.e2e:
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers import ECGOptions

        b = rng.standard_normal(a.shape[0])
        best_xla = min(("xla_scan_f64acc", "xla_unrolled_f64acc"),
                       key=ms.__getitem__)
        product = spmm.stencil_spmm_ext    # the Triton kernel on a GPU
        ops = {"product": product, best_xla: forms[best_xla]}
        try:
            for name in ("product", best_xla, best_xla, "product"):
                spmm.stencil_spmm_ext = ops[name]
                solver = DistributedECG.build(
                    a, nshards=1,
                    opts=ECGOptions(t=t, tol=1e-5, variant="odir_fused",
                                    layout="tbn"),
                    precond="bj2l", fmt="stencil", br=3,
                    grid=(nel + 1, nel + 1, nel), block_size=240,
                    dtype=np.float32)
                solver.solve(b)
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    xs, info = solver.solve(b)
                    times.append(time.perf_counter() - t0)
                relres = float(np.linalg.norm(b - a @ xs) / np.linalg.norm(b))
                print("e2e", name, json.dumps(dict(
                    solve_s=times, iters=info["iters"],
                    rounds=info.get("refine_rounds"), relres=relres)),
                    flush=True)
                del solver
        finally:
            spmm.stencil_spmm_ext = product
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
