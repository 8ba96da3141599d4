#!/usr/bin/env python
"""Weak-scaling sweep of the distributed ECG solve, with a comm/compute split.

Grows the problem with the shard count (constant rows/shard) and reports,
per row:

- ``iter_ms``     measured per-iteration wall time of the REAL distributed
                  solve (wall / iters at tol=1e-30, warm),
- ``comm_frac``   1 - iter_nocoll_ms/iter_ms, where iter_nocoll_ms is the
                  SAME solve re-traced with every collective a local no-op
                  (ops/blockops.timing_no_collectives — a real-solve
                  ablation: identical local compute and dispatch
                  structure, zero comm),
- ``comm_ms_chain``/``comm_frac_chain``  cross-check: scan-differential
                  time of a synthetic chain of the solve's collective
                  pattern at its shapes ((1+cheb_degree) halo ppermute
                  pairs + one small Gram psum per iteration),
- ``local_ms``    scan-differential time of the same iteration's LOCAL
                  compute (the (1+deg) stencil SpMMs on this shard's panel +
                  local Gram, no collectives) — the same per-shard work at
                  every shard count, so its growth over the nshards=1 row
                  measures CORE STARVATION on a virtual mesh (``starve_x``),
                  not communication.

On a host CPU the virtual devices SHARE physical cores, so wall-clock weak
efficiency conflates starvation with comm overhead; the comm-side number
(1 - comm_frac) is the one to read there. On real GPUs the same script
measures interconnect scaling.

Usage: python examples/weak_scaling.py [--base-nel 8] [--shards 1,2,4]
"""

import argparse
import functools
import json
import os
import time

import numpy as np


def _scan_ms(fn_builder, mesh, in_specs, state, lens=(8, 24), reps=2):
    """Scan-differential: jit fn(state, length) under shard_map at two scan
    lengths, difference the best wall times (the per-dispatch constant
    otherwise inflates short chains)."""
    import jax

    def _sync(o):
        jax.block_until_ready(o)
        return o

    timed = {}
    for length in lens:
        fn = fn_builder(mesh, in_specs, length)
        out = _sync(fn(*state))  # compile + warm
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            out = _sync(fn(*out) if isinstance(out, tuple) else fn(out))
            best = min(best, time.time() - t0)
        timed[length] = best
    return max((timed[lens[1]] - timed[lens[0]]) / (lens[1] - lens[0]) * 1e3,
               1e-6)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-nel", type=int, default=8)
    ap.add_argument("--shards", default="1,2,4,8")
    ap.add_argument("--t", type=int, default=8)
    ap.add_argument("--cheb-degree", type=int, default=8)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--cpu", action="store_true",
                    help="force the 8-virtual-device CPU mesh (e.g. when "
                         "no GPU is attached)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    try:  # jax >= 0.6 exposes shard_map at top level
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.core.layout import permute_and_pad_matrix
    from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
    from prealps_tpu.config import solve_dtype
    from prealps_tpu.ops.spmm import stencil_spmm_ext
    from prealps_tpu.parallel.driver import AXIS, DistributedECG
    from prealps_tpu.solvers import ECGOptions

    platform = jax.devices()[0].platform
    dtype = solve_dtype()   # f32 on the GPU, f64 on the CPU
    rng = np.random.default_rng(0)
    t, deg = args.t, args.cheb_degree
    local_base_ms = None

    for nshards in (int(v) for v in args.shards.split(",")):
        # scale z-extent with the shard count: rows/shard constant
        nel_z = args.base_nel * nshards
        a = elasticity3d(args.base_nel, args.base_nel, nel_z)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(
            t=t, tol=1e-30, maxiter=args.maxiter,
            variant="odir_fused", layout="tbn", record_history=False,
        )
        solver = DistributedECG.build(
            a, nshards=nshards, opts=opts, precond="chebyshev",
            fmt="stencil", br=3, dtype=dtype, refine=False,
            cheb_degree=deg,
        )
        solver.solve(b)  # compile + warm
        t0 = time.time()
        _, info = solver.solve(b)
        dt = time.time() - t0
        iter_ms = dt / max(info["iters"], 1) * 1e3
        nnz_s = a.nnz * info["iters"] / dt

        # REAL-SOLVE ablation: the same solver re-traced with every
        # collective a local no-op (ops/blockops.timing_no_collectives —
        # results wrong by construction, timing only). Same local compute,
        # same dispatch structure, zero comm: the difference to the real
        # solve is the solve's true communication time, and the ablation's
        # growth over nshards=1 is core starvation on a shared-core
        # virtual mesh.
        iter_nc_ms = iter_ms
        if nshards > 1:
            os.environ["PREALPS_TIMING_NO_COLLECTIVES"] = "1"
            try:
                solver_nc = DistributedECG.build(
                    a, nshards=nshards, opts=opts, precond="chebyshev",
                    fmt="stencil", br=3, dtype=dtype, refine=False,
                    cheb_degree=deg,
                )
                solver_nc.solve(b)  # compile + warm
                t0 = time.time()
                _, info_nc = solver_nc.solve(b)
                dt_nc = time.time() - t0
                # normalize by the ablation's OWN iteration count: its
                # arithmetic is garbage by construction, so the stall guard
                # may stop it before maxiter — per-iteration cost is the
                # comparable quantity
                iter_nc_ms = dt_nc / max(info_nc["iters"], 1) * 1e3
            finally:
                os.environ.pop("PREALPS_TIMING_NO_COLLECTIVES", None)
        comm_frac_solve = max(0.0, 1.0 - iter_nc_ms / iter_ms)

        # shapes of the real solve's comm pattern
        mesh = solver.mesh
        a_pad = permute_and_pad_matrix(
            solver.a_scaled if solver.a_scaled is not None else a,
            solver.layout)
        st = csr_to_stencil_bsr_t(a_pad, br=3, dtype=dtype)
        offsets = st.offsets
        halo = max(max(abs(o) for o in offsets), 1)
        nrb_loc = solver.layout.rows_per_shard // 3
        blocks_loc_spec = P(None, None, None, AXIS)
        fwd = [(i, (i + 1) % nshards) for i in range(nshards)]
        bwd = [(i, (i - 1) % nshards) for i in range(nshards)]

        def _comm_builder(mesh, specs, length, _f=fwd, _b=bwd):
            def body(x, g):
                def step(carry, _):
                    x, g = carry
                    for _ in range(deg + 1):
                        left = jax.lax.ppermute(x, AXIS, _f)
                        right = jax.lax.ppermute(x, AXIS, _b)
                        x = 0.5 * x + 0.25 * (left + right)
                    g = jax.lax.psum(g * (1.0 + 1e-6 * x[0, 0, 0]), AXIS)
                    g = g / jnp.sqrt(jnp.mean(g * g) + 1.0)
                    x = x * (1.0 + 1e-6 * g[0, 0])
                    return (x, g), None

                (x, g), _ = jax.lax.scan(step, (x, g), None, length=length)
                return x, g

            return jax.jit(shard_map(
                body, mesh=mesh, in_specs=specs,
                out_specs=specs, check_vma=False))

        # per-iteration collectives: (1+deg) halo slab exchanges + Gram psum
        x0 = jnp.asarray(
            rng.standard_normal((t, 3, halo)).astype(dtype))
        g0 = jnp.asarray(
            rng.standard_normal((7 * t, 5 * t)).astype(dtype))
        comm_ms = (_scan_ms(_comm_builder, mesh, (P(), P()), (x0, g0))
                   if nshards > 1 else 0.0)

        # same iteration's LOCAL compute at the same per-shard shapes:
        # (1+deg) stencil SpMMs on this shard's panel + a local Gram — no
        # collectives; growth over the nshards=1 row = core starvation
        def _local_builder(mesh, specs, length):
            def body(blocks, x):
                def step(x, _):
                    for _ in range(deg + 1):
                        x_ext = jnp.concatenate(
                            [x[:, :, -halo:], x, x[:, :, :halo]], axis=2)
                        x = stencil_spmm_ext(
                            blocks, offsets, x_ext, halo)
                        x = x / jnp.sqrt(jnp.mean(x * x) + 1.0)
                    g = jnp.einsum("abn,cbn->ac", x, x)
                    x = x * (1.0 + 1e-6 * g[0, 0])
                    return x, None

                x, _ = jax.lax.scan(step, x, None, length=length)
                return x

            f = jax.jit(shard_map(
                body, mesh=mesh, in_specs=specs,
                out_specs=P(None, None, AXIS), check_vma=False))
            return functools.partial(f, st.blocks_t)

        xl = jnp.asarray(
            rng.standard_normal((t, 3, nrb_loc * nshards)).astype(dtype))
        local_ms = _scan_ms(
            _local_builder, mesh,
            (blocks_loc_spec, P(None, None, AXIS)), (xl,))
        if local_base_ms is None:
            local_base_ms = local_ms

        print(json.dumps({
            "nshards": nshards, "n": a.shape[0], "nnz": a.nnz,
            "iters": info["iters"], "wall_s": round(dt, 3),
            "iter_ms": round(iter_ms, 3),
            "iter_nocoll_ms": round(iter_nc_ms, 3),
            "comm_frac": round(comm_frac_solve, 3),
            "comm_ms_chain": round(comm_ms, 3),
            "comm_frac_chain": round(comm_ms / iter_ms, 3),
            "local_ms": round(local_ms, 3),
            "starve_x": round(local_ms / local_base_ms, 3),
            "gnnz_per_s": round(nnz_s / 1e9, 3),
            "platform": platform,
        }), flush=True)


if __name__ == "__main__":
    main()
