"""Worker process for the 2-process jax.distributed CPU smoke test.

Launched by tests/test_distributed.py::TestMultihostGlue::test_two_process_solve
— the analog of the reference's `mpirun -np N` discipline
(reference: README.md:53, make.inc:25): two OS processes, each owning 4
virtual CPU devices, wired into ONE 8-device (host × chip) mesh via
`jax.distributed.initialize`, then THE LIBRARY SOLVER run distributed:
`prealps_tpu.solvers.ecg.ecg_solve` (odir_fused, lane-major) with the
stencil ppermute halo exchange and a block-Jacobi preconditioner, composed
under shard_map exactly as `parallel/driver.py` composes them — every Gram
psum and halo ppermute crosses the process boundary (the cross-host analog).
It exercises the product path, not a bespoke solver.

Usage: python tests/_multihost_worker.py <coordinator> <nproc> <pid> [mode]
mode "ecg" (default): ecg_solve + stencil halo + block Jacobi composed
under shard_map (prints "MULTIHOST_OK ..." on success).
mode "lorasc": the DRIVER-BUILT DistributedLorascECG (block-arrow
assembly, in-shard_map Lanczos deflation eigensolve, balancing-deflate
correction) on the cross-process ("shards","local") mesh — the
reference's test_lorasc-under-mpirun discipline (test_lorasc.c:168,
lorasc.c:95) with every separator psum and deflation-lift reduction
crossing the OS-process boundary (prints "MULTIHOST_LORASC_OK ...").
"""

import os
import sys


def _run_lorasc(nproc):
    """Library-driver LORASC across the 2-process global mesh."""
    import numpy as np

    import jax

    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu.solvers import ECGOptions

    assert jax.process_count() == nproc, jax.process_count()

    # every process builds from the same deterministic host matrix (the
    # reference reads the same .mtx on every rank — operator.c:38); the
    # build's jitted shard_maps then run as ONE global program
    a = elasticity3d(6, 5, 5)
    n = a.shape[0]
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)

    opts = ECGOptions(t=2, tol=1e-8, maxiter=2000, variant="odir_fused")
    nshards = len(jax.devices())
    solver = DistributedLorascECG.build(
        a, mesh_shape=(nshards // 2, 2), opts=opts, exact_schur=False,
        max_deflation=16, correction="deflate",
    )
    assert solver.deflated >= 1, "deflation eigensolve yielded no pairs"
    x, info = solver.solve(b)
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    assert relres < 1e-7, (relres, info)
    assert not info["breakdown"], info
    print(f"MULTIHOST_LORASC_OK relres={relres:.3e} "
          f"iters={info['iters']} pairs={solver.deflated}", flush=True)


def main():
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4] if len(sys.argv) > 4 else "ecg"
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from prealps_tpu.parallel import multihost

    multihost.initialize(coordinator=coord, num_processes=nproc,
                         process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())
    assert multihost.is_coordinator() == (pid == 0)

    if mode == "lorasc":
        return _run_lorasc(nproc)

    mesh = multihost.global_mesh_2level()
    assert mesh.devices.shape == (nproc, 4), mesh.devices.shape
    nshards = mesh.devices.size
    AXES = ("host", "chip")  # flattened: ring/psum cross the process boundary

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    try:  # jax >= 0.6 exposes shard_map at top level
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.core.layout import (
        contiguous_row_layout,
        pad_to_padded,
        permute_and_pad_matrix,
    )
    from prealps_tpu.direct.device_bj import bj_apply_flat
    from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
    from prealps_tpu.ops.spmm import stencil_spmm_ext
    from prealps_tpu.solvers import ECGOptions
    from prealps_tpu.solvers.ecg import ecg_solve

    # deterministic SPD stencil problem, identical on every process (the
    # reference reads the same .mtx on every rank's root and ships panels
    # over MPI — operator.c:38; here make_global materialises each
    # process's shards from the same host arrays)
    br, mbn = 3, 8
    mb = br * mbn
    a = elasticity3d(6, 6, 12)
    n = a.shape[0]
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)

    lay = contiguous_row_layout(n, nshards, row_multiple=mb)
    a_pad = permute_and_pad_matrix(a, lay)
    st = csr_to_stencil_bsr_t(a_pad, br=br, dtype=np.float64)
    assert st is not None, "elasticity3d must be stencil-structured"
    offsets = st.offsets
    h = max(max(abs(o) for o in offsets), 1)
    nrb_tot = lay.n_pad // br
    nrb_loc = lay.rows_per_shard // br
    assert h <= nrb_loc, (h, nrb_loc)   # genuine ring halo, not a gather

    # host-assembled flat block-Jacobi inverses (the driver builds these on
    # device — direct/device_bj.py; host numpy keeps this worker light)
    nb = nrb_tot // mbn
    inv_f = np.zeros((nb, mb, mb))
    ad = a_pad.toarray()
    # bj_apply_flat indexes block rows COMPONENT-major (comp*mbn + node,
    # the lane-major device convention); matrix rows are node-major
    dperm = np.arange(mb).reshape(mbn, br).T.ravel()  # flat idx -> row off
    for k in range(nb):
        blk = ad[k * mb:(k + 1) * mb, k * mb:(k + 1) * mb].copy()
        dz = np.flatnonzero(np.abs(np.diag(blk)) < 1e-300)
        blk[dz, dz] = 1.0   # identity on padded rows
        inv_f[k] = np.linalg.inv(blk)[np.ix_(dperm, dperm)]

    b_pad = pad_to_padded(lay, b)
    b_tbn = np.ascontiguousarray(b_pad.reshape(nrb_tot, br).T)  # (br, nrb)

    # globalize: each process materialises only its addressable shards
    blocks_g = multihost.make_global(
        mesh, P(None, None, None, AXES), np.asarray(st.blocks_t))
    inv_g = multihost.make_global(mesh, P(AXES, None, None), inv_f)
    b_g = multihost.make_global(mesh, P(None, AXES), b_tbn)

    opts = ECGOptions(t=4, tol=1e-10, maxiter=400, variant="odir_fused",
                      layout="tbn", record_history=False)
    fwd = [(i, (i + 1) % nshards) for i in range(nshards)]
    bwd = [(i, (i - 1) % nshards) for i in range(nshards)]

    @jax.jit
    def solve(b_loc_g, blocks_loc_g, inv_loc_g):
        def body(b_loc, blocks_loc, inv_loc):
            def a_apply(x):      # (t, br, nrb_loc)
                # stencil ring halo exchange (driver.py a_apply): wrap
                # entries multiply ZERO blocks, so the ring is exact
                left = jax.lax.ppermute(x[:, :, nrb_loc - h:], AXES, fwd)
                right = jax.lax.ppermute(x[:, :, :h], AXES, bwd)
                x_ext = jnp.concatenate([left, x, right], axis=2)
                return stencil_spmm_ext(blocks_loc, offsets, x_ext, h)

            def m_apply(r):
                return bj_apply_flat(inv_loc, r)

            res = ecg_solve(a_apply, m_apply, b_loc, opts, axis_name=AXES)
            return res.x, res.iters, res.res, res.normb

        return shard_map(
            body, mesh=mesh,
            in_specs=(P(None, AXES), P(None, None, None, AXES),
                      P(AXES, None, None)),
            out_specs=(P(None, AXES), P(), P(), P()),
            check_vma=False,
        )(b_loc_g, blocks_loc_g, inv_loc_g)

    x_g, iters, res_norm, normb = solve(b_g, blocks_g, inv_g)
    iters = int(np.asarray(jax.device_get(iters)))
    relres_rec = float(np.asarray(jax.device_get(res_norm))
                       / np.asarray(jax.device_get(normb)))

    # every process holds its own x shards; gather the per-process pieces on
    # host and verify the TRUE residual of the full system
    x_local = np.concatenate(
        [np.asarray(s.data) for s in
         sorted(x_g.addressable_shards,
                key=lambda s: s.index[1].start or 0)],
        axis=1)                                   # (br, nrb_local_total)
    from jax.experimental import multihost_utils

    x_full_tbn = (multihost_utils.process_allgather(x_local.T, tiled=True).T
                  if nproc > 1 else x_local)      # (br, nrb_tot)
    x_pad = x_full_tbn.T.reshape(lay.n_pad)
    x = x_pad[:n]                                 # identity layout perm
    relres_true = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    assert relres_true < 1e-9, (relres_true, relres_rec, iters)
    assert abs(relres_rec - relres_true) / max(relres_true, 1e-300) < 10.0, (
        relres_rec, relres_true)
    print(f"MULTIHOST_OK relres={relres_true:.3e} iters={iters}", flush=True)


if __name__ == "__main__":
    main()
