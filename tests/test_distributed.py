"""Distributed ECG on the 8-virtual-device CPU mesh.

Mirrors the reference's `mpirun -np 8` verification style (SURVEY.md §4.6):
the distributed result must match the single-shard result and satisfy the
end-to-end ‖b−Ax‖/‖b‖ check against the original matrix.
"""

import os

import jax
import numpy as np
import pytest

from prealps_tpu.parallel.driver import DistributedECG
from prealps_tpu.solvers import ECGOptions


def _relres(a, x, b):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def ela_b(ela_small):
    return np.random.default_rng(42).standard_normal(ela_small.shape[0])


class TestDistributedECG:
    def test_8shards_converges(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused")
        solver = DistributedECG.build(ela_small, nshards=8, opts=opts)
        x, info = solver.solve(ela_b)
        assert not info["breakdown"]
        assert _relres(ela_small, x, ela_b) < 2e-5  # sqrt(t) slack on the split-residual norm
        assert info["iters"] < 2000

    def test_matches_single_shard(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused")
        s1 = DistributedECG.build(ela_small, nshards=1, opts=opts)
        s8 = DistributedECG.build(ela_small, nshards=8, opts=opts)
        x1, i1 = s1.solve(ela_b)
        x8, i8 = s8.solve(ela_b)
        # different row orders => different rhs splits; iteration counts may
        # differ slightly but both must solve to the same accuracy
        assert _relres(ela_small, x1, ela_b) < 2e-5
        assert _relres(ela_small, x8, ela_b) < 2e-5

    @pytest.mark.parametrize("variant", ["omin", "odir"])
    def test_variants_distributed(self, ela_small, ela_b, variant):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant=variant)
        solver = DistributedECG.build(ela_small, nshards=4, opts=opts)
        x, info = solver.solve(ela_b)
        assert _relres(ela_small, x, ela_b) < 2e-5  # sqrt(t) slack on the split-residual norm

    def test_no_precond(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=3000)
        solver = DistributedECG.build(ela_small, nshards=8, opts=opts, precond="none")
        x, info = solver.solve(ela_b)
        assert _relres(ela_small, x, ela_b) < 2e-5  # sqrt(t) slack on the split-residual norm

    def test_adaptive_distributed(self, ela_small, ela_b):
        # freeze mode: the convergence-robust variant (truncate = exact
        # reference ADAPT_BS semantics, which stall on this problem —
        # see tests/test_parity.py)
        opts = ECGOptions(t=8, tol=1e-7, maxiter=3000, variant="odir_fused",
                          adaptive=True, adaptive_mode="freeze")
        solver = DistributedECG.build(ela_small, nshards=8, opts=opts)
        x, info = solver.solve(ela_b)
        assert _relres(ela_small, x, ela_b) < 2e-6

    def test_deterministic(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000)
        solver = DistributedECG.build(ela_small, nshards=8, opts=opts)
        x1, i1 = solver.solve(ela_b)
        x2, i2 = solver.solve(ela_b)
        np.testing.assert_array_equal(x1, x2)
        assert i1["iters"] == i2["iters"]


class TestBlockEllDistributed:
    def test_block_ell_xla_matches(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused")
        s = DistributedECG.build(ela_small, nshards=4, opts=opts, fmt="block_ell")
        x, info = s.solve(ela_b)
        assert _relres(ela_small, x, ela_b) < 2e-5


class TestStencilDistributed:
    def test_stencil_matches_ell(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused")
        s_st = DistributedECG.build(ela_small, nshards=4, opts=opts, fmt="stencil", br=3)
        s_el = DistributedECG.build(
            ela_small, nshards=4, opts=opts, fmt="ell", layout=s_st.layout
        )
        x1, i1 = s_st.solve(ela_b)
        x2, i2 = s_el.solve(ela_b)
        assert i1["iters"] == i2["iters"]
        np.testing.assert_allclose(x1, x2, rtol=1e-8, atol=1e-10)

    def test_stencil_single_shard(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused")
        s = DistributedECG.build(ela_small, nshards=1, opts=opts, fmt="stencil", br=3)
        x, info = s.solve(ela_b)
        assert _relres(ela_small, x, ela_b) < 2e-5

    def test_stencil_poisson_br1(self, poisson_small, rng):
        b = rng.standard_normal(poisson_small.shape[0])
        opts = ECGOptions(t=2, tol=1e-6, maxiter=500)
        s = DistributedECG.build(
            poisson_small, nshards=8, opts=opts, fmt="stencil", br=1, scale=False
        )
        x, info = s.solve(b)
        assert _relres(poisson_small, x, b) < 2e-5


class TestLaneMajorAndChebyshev:
    def test_tbn_matches_nt(self, ela_small, ela_b):
        from dataclasses import replace

        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused")
        s_nt = DistributedECG.build(
            ela_small, nshards=4, opts=opts, fmt="stencil", br=3, precond="none"
        )
        s_tbn = DistributedECG.build(
            ela_small, nshards=4, opts=replace(opts, layout="tbn"),
            fmt="stencil", br=3, precond="none",
        )
        x1, i1 = s_nt.solve(ela_b)
        x2, i2 = s_tbn.solve(ela_b)
        # layouts reduce in different orders: iteration counts may differ by
        # a rounding-level margin near the tolerance crossing
        assert abs(i1["iters"] - i2["iters"]) <= 1
        np.testing.assert_allclose(x1, x2, rtol=1e-5, atol=1e-6)

    def test_chebyshev_reduces_iterations(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=3000, variant="odir_fused")
        s0 = DistributedECG.build(
            ela_small, nshards=4, opts=opts, fmt="stencil", br=3, precond="none"
        )
        s1 = DistributedECG.build(
            ela_small, nshards=4, opts=opts, fmt="stencil", br=3,
            precond="chebyshev", cheb_degree=8,
        )
        x0, i0 = s0.solve(ela_b)
        x1, i1 = s1.solve(ela_b)
        assert _relres(ela_small, x1, ela_b) < 2e-5
        assert i1["iters"] < i0["iters"] // 2

    def test_tbn_chebyshev_all_variants(self, ela_small, ela_b):
        from dataclasses import replace

        # one non-fused variant here; the others are covered by
        # test_tbn_matches_nt / test_tbn_adaptive (keeps compile time down)
        for variant in ("odir",):
            opts = ECGOptions(
                t=4, tol=1e-6, maxiter=2000, variant=variant, layout="tbn"
            )
            s = DistributedECG.build(
                ela_small, nshards=2, opts=opts, fmt="stencil", br=3,
                precond="chebyshev",
            )
            x, info = s.solve(ela_b)
            assert _relres(ela_small, x, ela_b) < 2e-5, variant

    def test_tbn_adaptive(self, ela_small, ela_b):
        opts = ECGOptions(
            t=8, tol=1e-7, maxiter=3000, variant="odir_fused",
            adaptive=True, layout="tbn",
        )
        s = DistributedECG.build(
            ela_small, nshards=4, opts=opts, fmt="stencil", br=3,
            precond="chebyshev",
        )
        x, info = s.solve(ela_b)
        assert _relres(ela_small, x, ela_b) < 2e-6


class TestTwoLevelMesh:
    def test_two_level_gram_reduction(self, rng):
        """2-level communicator analog (reference: preAlps_utils.c:687
        comm2LevelsSplit): psum scoped per mesh axis composes to the global
        reduction — masterLevel ≡ 'host' axis, localLevel ≡ 'chip' axis."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from prealps_tpu.parallel.mesh import make_mesh_2level

        try:
            from jax import shard_map
        except ImportError:
            from jax.experimental.shard_map import shard_map

        mesh = make_mesh_2level(2, 4)
        x = rng.standard_normal((512, 3))

        def local(xl):
            g_local = jnp.einsum("mt,ms->ts", xl, xl)
            g_chip = jax.lax.psum(g_local, "chip")     # intra-group
            g_all = jax.lax.psum(g_chip, "host")       # cross-group
            return g_all

        fn = jax.jit(
            shard_map(local, mesh=mesh, in_specs=P(("host", "chip")),
                      out_specs=P(), check_vma=False)
        )
        g = np.asarray(fn(jnp.asarray(x)))
        np.testing.assert_allclose(g, x.T @ x, rtol=1e-12)

    def test_two_level_separator_pattern(self, rng):
        """LORASC multilevel pattern: interior work on 'chip', separator
        reduction spanning both axes (reference: lorasc.c:222-257 local-group
        Aii solves + masterLevel Agg solve)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from prealps_tpu.parallel.mesh import make_mesh_2level

        try:
            from jax import shard_map
        except ImportError:
            from jax.experimental.shard_map import shard_map

        mesh = make_mesh_2level(2, 4)
        v = rng.standard_normal((8 * 16,))

        def local2(vl):
            return jax.lax.psum(jnp.sum(vl), ("host", "chip"))[None]

        fn = jax.jit(
            shard_map(local2, mesh=mesh, in_specs=P(("host", "chip")),
                      out_specs=P(("host", "chip")), check_vma=False)
        )
        out = np.asarray(fn(jnp.asarray(v)))
        np.testing.assert_allclose(out, np.full(8, v.sum()), rtol=1e-12)


class TestDeviceBlockJacobi:
    def test_tbn_device_bj(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused",
                          layout="tbn")
        s = DistributedECG.build(
            ela_small, nshards=2, opts=opts, fmt="stencil", br=3,
            precond="block_jacobi", block_size=96,
        )
        x, info = s.solve(ela_b)
        assert _relres(ela_small, x, ela_b) < 2e-5

    def test_tbn_device_bj_beats_noprec(self, ela_small, ela_b):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=3000, variant="odir_fused",
                          layout="tbn")
        s0 = DistributedECG.build(
            ela_small, nshards=2, opts=opts, fmt="stencil", br=3, precond="none"
        )
        s1 = DistributedECG.build(
            ela_small, nshards=2, opts=opts, fmt="stencil", br=3,
            precond="block_jacobi", block_size=96,
        )
        x0, i0 = s0.solve(ela_b)
        x1, i1 = s1.solve(ela_b)
        assert i1["iters"] < i0["iters"]


class TestHaloExchange:
    """Dep-based halo exchange for general (ELL) matrices
    (reference: cplm_v0_matmult_v2.c dep-list halo SpMM)."""

    def test_ell_halo_solve_matches_scipy(self, ela_small):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers.ecg import ECGOptions

        a = ela_small
        rng = np.random.default_rng(5)
        b = rng.standard_normal(a.shape[0])
        solver = DistributedECG.build(
            a, nshards=8, opts=ECGOptions(t=4, tol=1e-8, maxiter=2000),
            precond="block_jacobi", fmt="ell", dtype=np.float64,
        )
        x, info = solver.solve(b)
        x_ref = spla.spsolve(sp.csc_matrix(a), b)
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-5
        # comm volume must be O(cut): true exchanged rows strictly below the
        # all-gather volume (each shard receiving all other shards' panels)
        plan = solver._halo_plan
        assert plan is not None
        lay = solver.layout
        allgather_rows = lay.nshards * (lay.n_pad - lay.rows_per_shard)
        assert plan.comm_rows < allgather_rows, (plan.comm_rows, allgather_rows)

    def test_halo_plan_spmm_equivalence(self, poisson_small):
        """The remapped-ELL gather over [own ∥ halo] reproduces A @ X."""
        import scipy.sparse as sp

        from prealps_tpu.core.layout import (
            build_halo_plan,
            build_row_layout,
            permute_and_pad_matrix,
        )
        from prealps_tpu.ops.formats import csr_to_ell

        a = sp.csr_matrix(poisson_small)
        layout = build_row_layout(a, 4)
        a_pad = permute_and_pad_matrix(a, layout)
        ell = csr_to_ell(a_pad, dtype=np.float64)
        cols = np.asarray(ell.cols)
        vals = np.asarray(ell.vals)
        plan = build_halo_plan(layout, cols, vals)

        rng = np.random.default_rng(0)
        x = rng.standard_normal((layout.n_pad, 3))
        mpl = layout.rows_per_shard
        s_n = layout.nshards
        y = np.zeros_like(x)
        for s in range(s_n):
            x_loc = x[s * mpl: (s + 1) * mpl]
            # emulate the all_to_all: recv[q] = x_q[send_idx[q, s]]
            recv = np.stack([
                x[q * mpl: (q + 1) * mpl][plan.send_idx[q, s]]
                for q in range(s_n)
            ])
            x_ext = np.concatenate([x_loc, recv.reshape(s_n * plan.h, -1)])
            rows = slice(s * mpl, (s + 1) * mpl)
            y[rows] = np.einsum(
                "ml,mlt->mt", vals[rows], x_ext[plan.cols_local[rows]]
            )
        np.testing.assert_allclose(y, a_pad @ x, rtol=1e-12, atol=1e-12)


class TestTwoLevelMeshSolve:
    """End-to-end solve on a 2-axis ("shards","local") mesh — the analog of
    the reference's masterLevel/localLevel split (preAlps_utils.c:687,
    multilevel Aii lorasc.c:222-256)."""

    def test_lorasc_two_level_matches_scipy(self, ela_small):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG
        from prealps_tpu.solvers.ecg import ECGOptions

        a = ela_small
        rng = np.random.default_rng(11)
        b = rng.standard_normal(a.shape[0])
        solver = DistributedLorascECG.build(
            a, opts=ECGOptions(t=2, tol=1e-8, maxiter=600),
            mesh_shape=(4, 2), dtype=np.float64, max_deflation=16,
        )
        assert solver.ngroups == 4 and solver.nlocal == 2
        x, info = solver.solve(b)
        x_ref = spla.spsolve(sp.csc_matrix(a), b)
        err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
        assert err < 1e-5, (err, info)
        assert not info["breakdown"]

    def test_one_and_two_level_agree(self, ela_small):
        """(8,) and (4,2) meshes are the same math — iteration counts and
        solutions must agree closely."""
        from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG
        from prealps_tpu.solvers.ecg import ECGOptions

        a = ela_small
        rng = np.random.default_rng(11)
        b = rng.standard_normal(a.shape[0])
        s1 = DistributedLorascECG.build(
            a, nshards=4, opts=ECGOptions(t=2, tol=1e-8, maxiter=600),
            dtype=np.float64, max_deflation=16,
        )
        s2 = DistributedLorascECG.build(
            a, opts=ECGOptions(t=2, tol=1e-8, maxiter=600),
            mesh_shape=(4, 2), dtype=np.float64, max_deflation=16,
        )
        x1, i1 = s1.solve(b)
        x2, i2 = s2.solve(b)
        assert abs(i1["iters"] - i2["iters"]) <= max(3, i1["iters"] // 10)
        np.testing.assert_allclose(x1, x2, rtol=1e-5, atol=1e-8)


class TestMultihostGlue:
    """Single-process sanity of the multi-host helpers — the code path
    the reference covers with mpirun (README.md:53); real multi-host needs a
    cluster, but mesh construction and process introspection must work locally."""

    def test_global_meshes(self):
        from prealps_tpu.parallel.multihost import (
            global_mesh,
            global_mesh_2level,
            is_coordinator,
            process_count,
        )

        m1 = global_mesh()
        assert m1.devices.size >= 8
        m2 = global_mesh_2level()
        assert m2.axis_names == ("host", "chip")
        assert m2.devices.size == m1.devices.size
        assert process_count() == 1
        assert is_coordinator()

    def test_globalize_helpers_single_process(self):
        """Single-process semantics of the multi-process plumbing the
        distributed LORASC build relies on: globalize_operands is an exact
        no-op (same objects, no uploads) and replicate_to_host is a plain
        host fetch — so the single-chip/CPU-mesh paths are provably
        untouched by the multi-process support."""
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from prealps_tpu.parallel.multihost import (
            global_mesh,
            globalize_operands,
            replicate_to_host,
        )

        mesh = global_mesh()
        ops = {"a": np.arange(8.0), "b": jnp.ones((4, 4))}
        specs = {"a": P("shards"), "b": P()}
        out = globalize_operands(mesh, specs, ops)
        assert out is ops  # identical dict, not a copy
        x = jnp.arange(16.0)
        got = replicate_to_host(mesh, x)
        np.testing.assert_array_equal(got, np.arange(16.0))
        # host numpy passes straight through too
        np.testing.assert_array_equal(
            replicate_to_host(mesh, np.arange(3.0)), np.arange(3.0))


class TestDiaDistributed:
    """Hybrid DIA+ELL over the mesh: diagonals via ring halo, stragglers
    via the dep-based ELL exchange."""

    def test_dia_solve_matches_scipy(self, ela_small):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers.ecg import ECGOptions

        a = ela_small
        rng = np.random.default_rng(5)
        b = rng.standard_normal(a.shape[0])
        solver = DistributedECG.build(
            a, nshards=8, opts=ECGOptions(t=4, tol=1e-8, maxiter=2000),
            precond="block_jacobi", fmt="dia", dtype=np.float64,
        )
        x, info = solver.solve(b)
        x_ref = spla.spsolve(sp.csc_matrix(a), b)
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-5

    def test_dia_banded_plus_noise(self, rng):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers.ecg import ECGOptions

        n = 1024
        diags = [np.full(n - abs(k), v) for k, v in
                 ((-16, -1.0), (-1, -2.0), (0, 8.0), (1, -2.0), (16, -1.0))]
        a = sp.diags(diags, offsets=[-16, -1, 0, 1, 16], format="csr")
        noise = sp.random(n, n, density=0.001, random_state=3)
        noise = 0.05 * (noise + noise.T)
        a = sp.csr_matrix(a + noise + 2 * sp.eye(n))
        b = rng.standard_normal(n)
        solver = DistributedECG.build(
            a, nshards=8, opts=ECGOptions(t=2, tol=1e-10, maxiter=3000),
            precond="none", fmt="dia", dtype=np.float64, scale=False,
        )
        x, info = solver.solve(b)
        x_ref = spla.spsolve(sp.csc_matrix(a), b)
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-7


class TestDeviceRefinement:
    """Mixed-precision refinement with the loop resident on device.

    The device path (lax.while_loop over inner ECG solves, f32 residuals)
    must match the host path (f64 residuals, per-round transfers) on both
    the reached tolerance and the round/iteration structure — the host loop
    is the reference semantics (reference: f64-native MKL solves; SURVEY §5
    precision adaptations).
    """

    def _build(self, a, fmt, **kw):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused",
                          layout="tbn" if fmt == "stencil" else "nt")
        return DistributedECG.build(
            a, nshards=8, opts=opts, dtype=np.float32, fmt=fmt,
            inner_tol=1e-3, **kw)

    @pytest.mark.parametrize("fmt", ["ell", "stencil"])
    def test_device_refine_converges(self, ela_small, ela_b, fmt, monkeypatch):
        kw = dict(br=3) if fmt == "stencil" else {}
        solver = self._build(ela_small, fmt, **kw)
        assert solver._refine_fn is not None
        x, info = solver.solve(ela_b)
        assert info["refine_rounds"] >= 1
        assert _relres(ela_small, x, ela_b) < 5e-5  # t-split slack over 1e-6
        # device loop must agree with the host reference loop
        monkeypatch.setenv("PREALPS_HOST_REFINE", "1")
        xh, infoh = solver.solve(ela_b)
        assert abs(info["refine_rounds"] - infoh["refine_rounds"]) <= 1
        assert np.linalg.norm(x - xh) / np.linalg.norm(xh) < 1e-3

    def test_refine_off_when_f64(self, ela_small):
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000)
        solver = DistributedECG.build(ela_small, nshards=8, opts=opts,
                                      dtype=np.float64)
        assert solver._refine_fn is None


class TestBf16BlockJacobi:
    def test_bf16_bj_iteration_count(self, ela_small, ela_b):
        """bf16-stored BJ inverses perturb M by ~0.3% — iteration count must
        stay within ~30% of the f32 build (explicit-inverse GEMM: one-shot
        rounding, no compounding)."""
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, variant="odir_fused",
                          layout="tbn")
        common = dict(nshards=8, opts=opts, dtype=np.float32, fmt="stencil",
                      br=3, inner_tol=1e-3, block_size=24)
        s32 = DistributedECG.build(ela_small, **common)
        sbf = DistributedECG.build(ela_small, bj_dtype="bf16", **common)
        x32, i32 = s32.solve(ela_b)
        xbf, ibf = sbf.solve(ela_b)
        assert _relres(ela_small, xbf, ela_b) < 5e-5
        assert ibf["iters"] <= max(int(1.3 * i32["iters"]), i32["iters"] + 12)


class TestBlockEllHalo:
    """Dep-based halo exchange at 128-column-block granularity for the
    distributed block-ELL path (closes the last all-gather SpMM)."""

    def test_block_ell_halo_solve_matches_scipy(self, ela_small):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        a = ela_small
        rng = np.random.default_rng(5)
        b = rng.standard_normal(a.shape[0])
        solver = DistributedECG.build(
            a, nshards=4, opts=ECGOptions(t=4, tol=1e-8, maxiter=2000),
            precond="block_jacobi", fmt="block_ell", dtype=np.float64,
        )
        x, info = solver.solve(b)
        x_ref = spla.spsolve(sp.csc_matrix(a), b)
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-5
        # comm ∝ cut blocks: strictly below the all-gather block volume
        plan = solver._halo_plan
        assert plan is not None and hasattr(plan, "comm_blocks")
        lay = solver.layout
        allgather_blocks = lay.nshards * (lay.n_pad - lay.rows_per_shard) // 128
        assert plan.comm_blocks < allgather_blocks, (
            plan.comm_blocks, allgather_blocks)

    def test_block_halo_plan_spmm_equivalence(self, poisson_small):
        """Gathering from [own blocks ∥ halo buffer] reproduces A @ X."""
        import jax.numpy as jnp
        import scipy.sparse as sp

        from prealps_tpu.core.layout import (
            build_block_halo_plan,
            build_row_layout,
            permute_and_pad_matrix,
        )
        from prealps_tpu.ops.formats import BlockEllMatrix, csr_to_block_ell
        from prealps_tpu.ops.spmm import block_ell_spmm

        a = sp.csr_matrix(poisson_small)
        s_n = 4
        lay = build_row_layout(a, s_n, row_multiple=128)
        a_pad = permute_and_pad_matrix(a, lay)
        bell = csr_to_block_ell(a_pad, bm=8, bk=128, dtype=np.float64)
        assert bell.shape[1] == lay.n_pad
        plan = build_block_halo_plan(
            lay, np.asarray(bell.blkcols), np.asarray(bell.blocks), bk=128)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((lay.n_pad, 3))
        want = a_pad @ x
        mpl = lay.rows_per_shard
        nblk_loc = mpl // 128
        nrb_loc = bell.blocks.shape[0] // s_n
        xb = x.reshape(-1, 128, 3)
        for s in range(s_n):
            # emulate the all_to_all: shard s's halo buffer is what every
            # shard q packed for destination s, in q-major order
            halo = np.concatenate(
                [xb[q * nblk_loc + plan.send_idx[q, s]] for q in range(s_n)],
                axis=0)
            xb_ext = np.concatenate([xb[s * nblk_loc:(s + 1) * nblk_loc],
                                     halo], axis=0)
            local = BlockEllMatrix(
                bell.blocks[s * nrb_loc:(s + 1) * nrb_loc],
                jnp.asarray(plan.blkcols_local[s * nrb_loc:(s + 1) * nrb_loc]),
                (mpl, xb_ext.shape[0] * 128),
            )
            got = np.asarray(block_ell_spmm(
                local, jnp.asarray(xb_ext.reshape(-1, 3))))
            np.testing.assert_allclose(got, want[s * mpl:(s + 1) * mpl],
                                       rtol=1e-10, atol=1e-10)


class TestBJDedupe:
    """Slab-aligned dedupe of repeated diagonal blocks (device_bj.py):
    constant-coefficient stencils store/read each unique inverse once."""

    def _problem(self):
        from prealps_tpu.core.generators import elasticity3d

        a = elasticity3d(6, 6, 8, heterogeneous=False)
        rng = np.random.default_rng(3)
        return a, rng.standard_normal(a.shape[0])

    def test_grouping_and_apply_match_per_block(self):
        import jax.numpy as jnp

        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.core.scaling import sym_rac_scaling
        from prealps_tpu.direct.device_bj import (
            bj_apply_grouped,
            bj_apply_lane_major,
            build_device_block_jacobi,
            build_device_block_jacobi_grouped,
            csr_slab_groups,
            stencil_slab_groups,
        )
        from prealps_tpu.ops.formats import csr_to_stencil_bsr_t

        a, _ = sym_rac_scaling(elasticity3d(6, 6, 8, heterogeneous=False))
        sb = csr_to_stencil_bsr_t(a, br=3)
        mbn = 7 * 7                      # one z-slab of nodes
        nrb = a.shape[0] // 3
        nb = nrb // mbn
        rep_idx, groups = csr_slab_groups(a, mbn * 3)
        assert len(rep_idx) < nb         # interior slabs dedupe
        assert sorted(i for g in groups for i in g) == list(range(nb))
        # host-CSR grouping must agree with the stencil-array grouping
        blocks_host = np.asarray(jnp.transpose(sb.blocks_t, (3, 0, 1, 2)))
        assert stencil_slab_groups(blocks_host, mbn)[1] == groups

        inv5 = build_device_block_jacobi(sb.blocks_t, sb.offsets, mbn=mbn)
        inv_u = build_device_block_jacobi_grouped(
            sb.blocks_t, sb.offsets, mbn=mbn, rep_idx=rep_idx)
        rng = np.random.default_rng(0)
        z = jnp.asarray(rng.standard_normal((4, 3, nrb)))
        w_ref = bj_apply_lane_major(inv5, z)
        w_grp = bj_apply_grouped(inv_u, groups, z)
        np.testing.assert_allclose(np.asarray(w_grp), np.asarray(w_ref),
                                   rtol=1e-12, atol=1e-12)

    def test_solve_matches_non_deduped(self):
        a, b = self._problem()
        opts = ECGOptions(t=4, tol=1e-8, maxiter=2000, variant="odir_fused",
                          layout="tbn")
        s_plain = DistributedECG.build(
            a, nshards=1, opts=opts, fmt="stencil", br=3,
            precond="block_jacobi", block_size=49 * 3, bj_dedupe=False,
        )
        s_dedup = DistributedECG.build(
            a, nshards=1, opts=opts, fmt="stencil", br=3,
            precond="block_jacobi", grid=(7, 7, 8),
        )
        x0, i0 = s_plain.solve(b)
        x1, i1 = s_dedup.solve(b)
        assert _relres(a, x1, b) < 1e-7
        # same preconditioner (same slab blocks) -> same convergence
        assert abs(int(i0["iters"]) - int(i1["iters"])) <= 2

    def test_irregular_matrix_falls_back(self):
        """A heterogeneous (non-repeating at nb<=2*ng) matrix must take the
        per-block path and still solve."""
        from prealps_tpu.core.generators import elasticity3d

        a = elasticity3d(6, 6, 8, heterogeneous=True)
        rng = np.random.default_rng(4)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-8, maxiter=3000, variant="odir_fused",
                          layout="tbn")
        s = DistributedECG.build(
            a, nshards=1, opts=opts, fmt="stencil", br=3,
            precond="block_jacobi", grid=(7, 7, 8),
        )
        x, info = s.solve(b)
        assert _relres(a, x, b) < 1e-7


class TestTwoLevelBJ:
    """bj2l: block Jacobi + geometric-RBM (Nicolaides) coarse space
    (precond/twolevel.py). The coarse correction must cut iterations vs
    plain BJ — the per-block Dirichlet low modes provably cannot (they
    vanish on block boundaries; kept as the algebraic fallback)."""

    def test_iteration_cut_and_convergence(self):
        from prealps_tpu.core.generators import elasticity3d

        a = elasticity3d(10, 10, 10, heterogeneous=True)
        rng = np.random.default_rng(1)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-8, maxiter=6000, variant="odir_fused",
                          layout="tbn")
        counts = {}
        for pc, kw in (("block_jacobi", {}),
                       ("bj2l", dict(grid=(11, 11, 10)))):
            s = DistributedECG.build(
                a, nshards=1, opts=opts, fmt="stencil", br=3,
                precond=pc, block_size=128, **kw)
            x, info = s.solve(b)
            assert _relres(a, x, b) < 1e-7
            counts[pc] = int(info["iters"])
        # measured 329 -> 220 at this size; assert a real (>15%) cut
        assert counts["bj2l"] < 0.85 * counts["block_jacobi"]

    def test_multishard_matches_single(self):
        """Sharded bj2l (all-gathered coarse residual + replicated coarse
        solve) must reproduce the single-shard preconditioner exactly."""
        from prealps_tpu.core.generators import elasticity3d

        a = elasticity3d(8, 8, 8, heterogeneous=True)
        rng = np.random.default_rng(2)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-8, maxiter=6000, variant="odir_fused",
                          layout="tbn")
        counts = {}
        for ns in (1, 4):
            s = DistributedECG.build(
                a, nshards=ns, opts=opts, fmt="stencil", br=3,
                precond="bj2l", block_size=96, grid=(9, 9, 8))
            x, info = s.solve(b)
            assert _relres(a, x, b) < 1e-7
            counts[ns] = int(info["iters"])
        # same preconditioner; reduction orders differ across meshes
        assert abs(counts[1] - counts[4]) <= max(5, counts[1] // 20)


class TestDiaLaneMajor:
    """fmt='dia' + layout='tbn': general (promoted-diagonal) matrices on the
    lane-major fast path — a DIA matrix is a br=1 stencil, so it rides the
    same kernels, lane-major panels, and flat device block Jacobi as the
    grid operators; stragglers apply via one transposed ELL gather."""

    def test_matches_row_major_dia(self):
        from prealps_tpu.core.generators import elasticity3d

        a = elasticity3d(8, 7, 7, heterogeneous=True)
        rng = np.random.default_rng(1)
        b = rng.standard_normal(a.shape[0])
        res = {}
        for layout in ("nt", "tbn"):
            opts = ECGOptions(t=4, tol=1e-8, maxiter=4000,
                              variant="odir_fused", layout=layout)
            s = DistributedECG.build(a, nshards=1, opts=opts, fmt="dia",
                                     precond="block_jacobi", block_size=120)
            x, info = s.solve(b)
            assert _relres(a, x, b) < 1e-7
            res[layout] = int(info["iters"])
        # same diagonals; BJ blocks differ slightly (dia assembles from
        # promoted diagonals only) — allow a modest band
        assert abs(res["tbn"] - res["nt"]) <= max(10, res["nt"] // 5)

    def test_irregular_matrix_with_stragglers(self):
        import scipy.sparse as sp

        rng = np.random.default_rng(3)
        n = 1200
        main = sp.diags(
            [np.full(n - 1, -1.0), np.full(n, 6.0), np.full(n - 1, -1.0),
             np.full(n - 40, -0.5), np.full(n - 40, -0.5)],
            offsets=[-1, 0, 1, 40, -40], format="csr")
        pts = rng.choice(n * n, 300, replace=False)
        rr, cc = pts // n, pts % n
        extra = sp.coo_matrix((np.full(300, -0.05), (rr, cc)), shape=(n, n))
        a = sp.csr_matrix(main + extra + extra.T)
        b = rng.standard_normal(n)
        opts = ECGOptions(t=4, tol=1e-8, maxiter=4000, variant="odir_fused",
                          layout="tbn")
        s = DistributedECG.build(a, nshards=1, opts=opts, fmt="dia",
                                 precond="block_jacobi", block_size=64)
        x, info = s.solve(b)
        assert _relres(a, x, b) < 1e-7

    def test_multishard_converges(self):
        """Distributed dia+tbn: ring halo for the diagonals + dep-based
        all_to_all for the straggler remainder on the transposed panel."""
        from prealps_tpu.core.generators import elasticity3d

        a = elasticity3d(8, 7, 7, heterogeneous=True)
        rng = np.random.default_rng(5)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-8, maxiter=4000, variant="odir_fused",
                          layout="tbn")
        s = DistributedECG.build(a, nshards=4, opts=opts, fmt="dia",
                                 precond="block_jacobi", block_size=120)
        x, info = s.solve(b)
        assert _relres(a, x, b) < 1e-7


class TestMultihost2Proc:
    """TWO real OS processes under jax.distributed on the CPU backend — the
    cross-process execution discipline the reference gets from `mpirun -np N`
    (README.md:53): the multihost.py glue runs with >= 2 processes."""

    @staticmethod
    def _launch_workers(mode, ok_token, timeout=300):
        import socket
        import subprocess
        import sys as _sys

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        coord = f"localhost:{port}"

        here = os.path.dirname(os.path.abspath(__file__))
        worker = os.path.join(here, "_multihost_worker.py")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        # workers import the package from this checkout only
        env["PYTHONPATH"] = os.path.dirname(here)
        procs = [
            subprocess.Popen(
                [_sys.executable, worker, coord, "2", str(pid), mode],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, cwd=os.path.dirname(here),
            )
            for pid in range(2)
        ]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for rc, out, err in outs:
            assert rc == 0, (rc, out[-500:], err[-2000:])
            assert ok_token in out, (out[-500:], err[-1000:])

    def test_two_process_solve(self):
        self._launch_workers("ecg", "MULTIHOST_OK")

    def test_two_process_lorasc(self):
        """The DRIVER-BUILT distributed LORASC (block-arrow + in-shard_map
        Lanczos deflation + balancing-deflate correction) across 2 OS
        processes: build-time operand globalization + the solve's
        cross-process separator psums (the reference's test_lorasc under
        mpirun — test_lorasc.c:168)."""
        self._launch_workers("lorasc", "MULTIHOST_LORASC_OK", timeout=420)
