#!/usr/bin/env python
"""Halo-exchange / compute overlap measurement.

The reference's distributed SpMM ISends the X panel, computes the
diagonal-block SpMM while the messages fly, then accumulates per-arrival
(reference: utils/cplm_v0/cplm_v0_matmult_v2.c:184-321). The JAX
equivalent issues the ring ppermute and the local stencil compute in one
jitted program and leaves the interleaving to XLA. This script MEASURES how
much overlap XLA actually achieves, by timing three variants of one
distributed SpMM step on the 8-virtual-device CPU mesh (or on real GPUs
with OVERLAP_ON_GPU=1):

    full     = halo ppermute + local SpMM on the extended panel
    compute  = local SpMM only (halos = own wrap slices, no collective)
    halo     = ppermute only (+trivial use of the result)

overlap efficiency = (compute + halo - full) / min(compute, halo)
    1.0 -> perfectly hidden; 0.0 -> fully serialized.

Timing: lax.scan chains inside ONE dispatch, two lengths differenced.
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    n_dev = int(os.environ.get("OVERLAP_NDEV", "8"))
    # OVERLAP_ON_GPU=1 runs on n_dev real GPUs; default: n_dev virtual CPU
    # devices (config must precede backend init)
    if not int(os.environ.get("OVERLAP_ON_GPU", "0")):
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", n_dev)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map as shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.core.layout import (
        contiguous_row_layout,
        permute_and_pad_matrix,
    )
    from prealps_tpu.core.scaling import sym_rac_scaling
    from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
    from prealps_tpu.config import solve_dtype
    from prealps_tpu.ops.spmm import stencil_spmm_ext

    nel = int(os.environ.get("OVERLAP_NEL", "24"))
    t = 12
    br = 3
    a = elasticity3d(nel, nel, nel)
    a, _ = sym_rac_scaling(a)
    dtype = solve_dtype()   # f32 on the GPU, f64 on the CPU
    lay = contiguous_row_layout(a.shape[0], n_dev, row_multiple=br * n_dev)
    apad = permute_and_pad_matrix(a, lay)
    sb = csr_to_stencil_bsr_t(apad, br=br, dtype=dtype)
    s_max = len(sb.offsets)
    nrb_tot = lay.n_pad // br
    nrb_loc = nrb_tot // n_dev
    halo = max(abs(o) for o in sb.offsets)
    assert halo <= nrb_loc, (halo, nrb_loc)
    nnz = a.nnz

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("shards",))
    rng = np.random.default_rng(0)
    xt = jnp.asarray(
        rng.standard_normal((t, br, nrb_tot)).astype(dtype))
    blocks = sb.blocks_t

    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def step_full(b_loc, x_loc):
        left = jax.lax.ppermute(x_loc[:, :, nrb_loc - halo:], "shards", fwd)
        right = jax.lax.ppermute(x_loc[:, :, :halo], "shards", bwd)
        x_ext = jnp.concatenate([left, x_loc, right], axis=2)
        return stencil_spmm_ext(b_loc, sb.offsets, x_ext, halo)

    def step_compute(b_loc, x_loc):
        x_ext = jnp.concatenate(
            [x_loc[:, :, nrb_loc - halo:], x_loc, x_loc[:, :, :halo]], axis=2)
        return stencil_spmm_ext(b_loc, sb.offsets, x_ext, halo)

    def step_halo(b_loc, x_loc):
        left = jax.lax.ppermute(x_loc[:, :, nrb_loc - halo:], "shards", fwd)
        right = jax.lax.ppermute(x_loc[:, :, :halo], "shards", bwd)
        # trivial use, negligible compute
        return x_loc + 1e-30 * jnp.concatenate(
            [left, right], axis=2).sum(axis=2, keepdims=True)

    def timed(step, label):
        norm = lambda y: y / jnp.sqrt(jnp.mean(y * y) + 1.0)

        def chained(b_loc, x_loc, k):
            z, _ = jax.lax.scan(
                lambda c, _: (norm(step(b_loc, c)), None), x_loc, None,
                length=k)
            return z

        @functools.partial(jax.jit, static_argnums=1)
        def run(x, k):
            f = shard_map(
                lambda b, xl: chained(b, xl, k), mesh=mesh,
                in_specs=(P(None, None, None, "shards"),
                          P(None, None, "shards")),
                out_specs=P(None, None, "shards"),
                check_vma=False,
            )
            return f(blocks, x)

        z = run(xt, 8)
        z.block_until_ready()

        def best(k, z0, reps=3):
            b = 1e9
            zz = z0
            for _ in range(reps):
                t0 = time.time()
                zz = run(zz, k)
                zz.block_until_ready()
                b = min(b, time.time() - t0)
            return b, zz

        t_s, z = best(8, z)
        t_l, _ = best(40, z)
        per = (t_l - t_s) / 32 * 1e3
        print(f"{label}: {per:.3f} ms/step", flush=True)
        return per

    t_full = timed(step_full, "full (halo + compute)")
    t_comp = timed(step_compute, "compute only")
    t_halo = timed(step_halo, "halo only")
    denom = min(t_comp, t_halo)
    eff = (t_comp + t_halo - t_full) / denom if denom > 0 else float("nan")
    print(f"n={a.shape[0]} nnz={nnz} ndev={n_dev} backend="
          f"{jax.default_backend()}")
    print(f"overlap efficiency = (compute + halo - full)/min = {eff:.2f} "
          "(1.0 = fully hidden, 0 = serialized)")


if __name__ == "__main__":
    main()
