"""Scalable LORASC (precond/lorasc_scale.py + parallel/lorasc_stencil.py)
vs scipy references — the production redesign of the round-1 toy LORASC."""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax.numpy as jnp

from prealps_tpu.core.gridpart import (
    collapse_to_nodes,
    factor3,
    grid_box_partition,
)
from prealps_tpu.precond.lorasc_scale import (
    build_scalable_lorasc,
    plan_arrow_bands,
)


class TestGridPartition:
    def test_factor3(self):
        assert factor3(8) == (2, 2, 2)
        assert factor3(4) == (2, 2, 1)
        assert np.prod(factor3(12)) == 12

    def test_separator_decouples_interiors(self):
        from prealps_tpu.core.generators import poisson3d

        a = poisson3d(8, 7, 6)
        gx, gy, gz = 8, 7, 6
        part, in_sep = grid_box_partition(gx, gy, gz, 8)
        assert part.shape[0] == a.shape[0]
        coo = a.tocoo()
        interior = ~in_sep
        cross = (
            interior[coo.row] & interior[coo.col]
            & (part[coo.row] != part[coo.col])
        )
        assert not np.any(cross), "interiors of different boxes must not couple"

    def test_collapse_to_nodes(self, ela_small):
        pat = collapse_to_nodes(ela_small, 3)
        assert pat.shape[0] * 3 == ela_small.shape[0]


def _make(a, br, nparts, grid=None, **kw):
    return build_scalable_lorasc(
        a, nparts=nparts, br=br, grid=grid, dtype=np.float64, **kw
    )


def _arrow_pieces(a, plan):
    """Extract Aii blocks / Agg / couplings in the plan's arrow order."""
    br = plan.br
    int_dofs = []  # per part list of dof indices in band order
    for p in range(plan.nparts):
        nodes = plan.int_nodes[p]
        nodes = nodes[nodes < plan.nrb]
        dofs = (nodes[:, None] * br + np.arange(br)[None, :]).ravel()
        int_dofs.append(dofs)
    sep_nodes = plan.sep_nodes[plan.sep_nodes < plan.nrb]
    sep_dofs = (sep_nodes[:, None] * br + np.arange(br)[None, :]).ravel()
    return int_dofs, sep_dofs


class TestScalableLorascApply:
    @pytest.mark.parametrize("grid_mode", ["box", "generic"])
    def test_apply_matches_reference_formula(self, grid_mode):
        """apply() must equal the exact LORASC sweep computed with scipy
        (reference: lorasc.c:368-618), given the same deflation basis."""
        from prealps_tpu.core.generators import elasticity3d

        nel = (4, 3, 3)
        a = elasticity3d(*nel)
        br, nparts = 3, 4
        grid = (nel[0] + 1, nel[1] + 1, nel[2]) if grid_mode == "box" else None
        lor = _make(a, br, nparts, grid=grid, max_deflation=8)
        plan = lor.plan

        int_dofs, sep_dofs = _arrow_pieces(a, plan)
        all_int = np.concatenate(int_dofs)
        aii = a[all_int][:, all_int]
        aig = a[all_int][:, sep_dofs]
        agi = a[sep_dofs][:, all_int]

        rng = np.random.default_rng(3)
        t = 2
        r = rng.standard_normal((a.shape[0], t))

        # device apply (lane-major in/out)
        r_lane = jnp.asarray(
            np.ascontiguousarray(r.reshape(plan.nrb, br, t).transpose(2, 1, 0))
        )
        w_lane = np.asarray(lor.apply(r_lane))
        w = w_lane.transpose(2, 1, 0).reshape(a.shape[0], t)

        # scipy reference sweep with the SAME (E, sigma)
        ng_real = sep_dofs.size
        e_np = np.asarray(lor.operands["e_mat"])[:ng_real]
        sig = np.asarray(lor.operands["sigma"])
        vi = r[all_int]
        vg = r[sep_dofs]
        zi = spla.spsolve(sp.csc_matrix(aii), vi)
        g = vg - agi @ zi
        agg = a[sep_dofs][:, sep_dofs]
        zg = spla.spsolve(sp.csc_matrix(agg), g) + e_np @ (
            (sig[:, None]) * (e_np.T @ g)
        )
        wi = zi - spla.spsolve(sp.csc_matrix(aii), aig @ zg)
        w_ref = np.zeros_like(r)
        w_ref[all_int] = wi
        w_ref[sep_dofs] = zg

        err = np.linalg.norm(w - w_ref) / np.linalg.norm(w_ref)
        assert err < 1e-8, err

    def test_deflation_matches_dense_eigs(self):
        """Lanczos deflation pairs ≈ scipy generalized eigh of (S, Agg)."""
        from prealps_tpu.core.generators import poisson3d

        a = poisson3d(6, 6, 5)
        lor = _make(a, 1, 4, grid=(6, 6, 5), max_deflation=6)
        plan = lor.plan
        int_dofs, sep_dofs = _arrow_pieces(a, plan)
        all_int = np.concatenate(int_dofs)
        aii = a[all_int][:, all_int]
        aig = a[all_int][:, sep_dofs]
        agi = a[sep_dofs][:, all_int]
        agg = a[sep_dofs][:, sep_dofs].toarray()
        s = agg - agi @ spla.spsolve(sp.csc_matrix(aii), aig.tocsc()).toarray()
        lam_ref = scipy.linalg.eigh(0.5 * (s + s.T), agg, eigvals_only=True)

        sig = np.asarray(lor.operands["sigma"])
        ndefl = int((sig > 0).sum())
        tol = 1e-2
        n_ref = int((lam_ref <= tol * (1 + 1e-9)).sum())
        # Lanczos finds the small end of the pencil spectrum
        assert abs(ndefl - min(n_ref, 6)) <= 1
        if ndefl:
            lam_lz = tol / (sig[:ndefl] + 1.0)
            np.testing.assert_allclose(
                np.sort(lam_lz), np.sort(lam_ref[:ndefl]), rtol=1e-4, atol=1e-8
            )

    def test_plan_bandwidth_bound(self, ela_small):
        node_graph = collapse_to_nodes(ela_small, 3)
        part, in_sep = grid_box_partition(7, 6, 5, 4)
        plan = plan_arrow_bands(node_graph, part, in_sep, 4, 3)
        assert plan.bs_i % 3 == 0 and plan.bs_i % 8 == 0
        assert plan.nbn_i * 3 == plan.nblk_i * plan.bs_i


class TestStencilLorascSolve:
    def test_solve_elasticity(self, ela_small):
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers.ecg import ECGOptions

        a = ela_small
        solver = StencilLorascECG.build(
            a, nparts=4, br=3, grid=(7, 6, 5),
            opts=ECGOptions(t=2, tol=1e-6, maxiter=400, layout="tbn"),
            dtype=np.float64,
        )
        rng = np.random.default_rng(11)
        b = rng.standard_normal(a.shape[0])
        x, info = solver.solve(b)
        relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
        assert relres < 1e-5, (relres, info)
        assert not info["breakdown"]

    def test_lorasc_beats_block_jacobi_iterations(self):
        """The reference's headline claim: LORASC cuts the iteration count
        massively vs block Jacobi on heterogeneous elasticity
        (BASELINE.md Table 4: 4058 -> 102)."""
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.core.partition import nsplit
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers.ecg import ECGOptions
        from tests.ecg_oracle import block_jacobi_oracle, ecg_oracle

        a = elasticity3d(6, 6, 6, heterogeneous=True)
        rng = np.random.default_rng(11)
        b = rng.standard_normal(a.shape[0])

        m_bj = block_jacobi_oracle(a, nsplit(a.shape[0], 8))
        k_bj = ecg_oracle(a, b, t=2, tol=1e-6, variant="odir", m_apply=m_bj,
                          maxiter=3000)["iters"]

        solver = StencilLorascECG.build(
            a, nparts=8, br=3, grid=(7, 7, 6),
            opts=ECGOptions(t=2, tol=1e-6, maxiter=3000, layout="tbn"),
            dtype=np.float64, max_deflation=24,
        )
        x, info = solver.solve(b)
        relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
        assert relres < 1e-5
        assert info["iters"] < 0.5 * k_bj, (info["iters"], k_bj)


class TestHostRefinedPairs:
    def test_refined_pairs_do_not_hurt_and_match_f64_quality(self, rng):
        """Host f64 Rayleigh-Ritz refinement of the f32 device pairs
        (round 3): refined vectors are B-orthonormal to f64 accuracy and
        the preconditioner converges at least as fast as with raw f32
        pairs (the f32-f64 gap is vector noise)."""
        import jax.numpy as jnp

        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers import ECGOptions

        nel = 12
        a = elasticity3d(nel, nel, nel, heterogeneous=True)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-5, maxiter=4000,
                          variant="odir_fused", layout="tbn")
        runs = {}
        for hr in (False, True):
            s = StencilLorascECG.build(
                a, nparts=4, br=3, grid=(nel + 1, nel + 1, nel), opts=opts,
                dtype=np.float32, max_deflation=48, host_refine=hr,
            )
            x, info = s.solve(b)
            relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
            assert relres < 1e-4
            runs[hr] = info["iters"]
        # "does not hurt" within iteration noise: ±2 under the scalar
        # Lanczos; the block iteration (PREALPS_LANCZOS_BLOCK) lands a
        # slightly different (equally valid) pair set, so allow a few more
        assert runs[True] <= runs[False] + 5, runs


class TestBalancingDeflation:
    """correction="deflate": the balancing/BNN projection form
    (lorasc_scale._attach_deflation_lift + lorasc_apply deflate branch)."""

    def test_apply_matches_bnn_formula(self):
        """deflate apply == Pᵀ M0⁻¹ P + Q computed densely with scipy over
        the same lifted basis Ŵ = [−Aii⁻¹Aig E; E] and floored Λc."""
        from prealps_tpu.core.generators import elasticity3d

        nel = (4, 3, 3)
        a = elasticity3d(*nel)
        br, nparts = 3, 4
        lor = _make(a, br, nparts, grid=(nel[0] + 1, nel[1] + 1, nel[2]),
                    max_deflation=8, correction="deflate")
        plan = lor.plan
        assert "w_lift" in lor.operands, "no pairs deflated; test needs some"

        int_dofs, sep_dofs = _arrow_pieces(a, plan)
        all_int = np.concatenate(int_dofs)
        n = a.shape[0]
        aii = sp.csc_matrix(a[all_int][:, all_int])
        aig = a[all_int][:, sep_dofs]
        agi = a[sep_dofs][:, all_int]
        agg = sp.csc_matrix(a[sep_dofs][:, sep_dofs])

        # M0⁻¹ (no correction) as a dense action, arrow coordinates
        def m0_inv(v):
            vi, vg = v[: all_int.size], v[all_int.size:]
            zi = spla.spsolve(aii, vi)
            zg = spla.spsolve(agg, vg - agi @ zi)
            wi = zi - spla.spsolve(aii, aig @ zg)
            return np.concatenate([wi, zg])

        # lifted basis from the device operands (lane-major (k, br, nrb))
        w_dev = np.asarray(lor.operands["w_lift"])
        k = w_dev.shape[0]
        w_full = w_dev.transpose(2, 1, 0).reshape(n, k)   # original ordering
        perm = np.concatenate([all_int, sep_dofs])
        w_arrow = w_full[perm]
        linv = np.asarray(lor.operands["coarse_linv"])
        lc_inv = linv.T @ linv
        a_arrow = a[perm][:, perm]
        aw = np.asarray(a_arrow @ w_arrow)

        rng = np.random.default_rng(5)
        r = rng.standard_normal(n)
        r_arrow = r[perm]
        # BNN: z = Pᵀ y + Q r,  P r = r − AŴ Λc⁻¹ Ŵᵀ r,  y = M0⁻¹ P r
        c1 = w_arrow.T @ r_arrow
        pr = r_arrow - aw @ (lc_inv @ c1)
        y = m0_inv(pr)
        z_ref_arrow = y + w_arrow @ (lc_inv @ (c1 - aw.T @ y))
        z_ref = np.zeros(n)
        z_ref[perm] = z_ref_arrow

        r_lane = jnp.asarray(
            np.ascontiguousarray(r.reshape(plan.nrb, br).T)[None]
        )
        z_lane = np.asarray(lor.apply(r_lane))
        z = z_lane[0].T.reshape(n)
        # the device apply uses AŴ = [0; SE] (interior block exactly zero by
        # the harmonic-lift identity); the scipy A·Ŵ above carries the
        # banded-solve truncation in that block, hence the loose-ish band
        err = np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref)
        assert err < 1e-6, err

    def test_deflate_matches_sigma_iterations_f64(self, rng):
        """In f64 both correction forms handle the deflated modes (σ maps
        them to the deflation tol, BNN to 1) — iteration counts must be in
        the same class."""
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers import ECGOptions

        nel = 8
        a = elasticity3d(nel, nel, nel, heterogeneous=True)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-6, maxiter=3000, layout="tbn")
        iters = {}
        for corr in ("sigma", "deflate"):
            s = StencilLorascECG.build(
                a, nparts=4, br=3, grid=(nel + 1, nel + 1, nel), opts=opts,
                dtype=np.float64, max_deflation=24, correction=corr,
            )
            x, info = s.solve(b)
            relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
            assert relres < 1e-5, (corr, relres)
            iters[corr] = info["iters"]
        assert iters["deflate"] <= 1.25 * iters["sigma"], iters

    def test_deflate_f32_tracks_f64_with_omin(self, rng):
        """The round-3 σ-cap causal chain showed f32 σ-LORASC costs ~2.3×
        the f64 iteration count (amplified components vs f32 state). The
        balancing form + omin must track the f64 count: this is the
        f32-robust production configuration."""
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers import ECGOptions

        nel = 14
        a = elasticity3d(nel, nel, nel, heterogeneous=True)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=12, tol=1e-3, maxiter=6000, layout="tbn",
                          variant="omin")
        iters = {}
        for dt in (np.float64, np.float32):
            s = StencilLorascECG.build(
                a, nparts=8, br=3, grid=(nel + 1, nel + 1, nel), opts=opts,
                dtype=dt, max_deflation=48, correction="deflate",
                refine=False,
            )
            x, info = s.solve(b)
            relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
            assert relres < 5e-3, (dt, relres)   # TRUE residual, not recursive
            iters[np.dtype(dt).name] = info["iters"]
        assert iters["float32"] <= 1.5 * iters["float64"] + 5, iters


class TestFactorStore:
    """bf16 banded-factor storage (build_scalable_lorasc factor_store):
    the apply's dominant byte stream halved at a ~3e-3 operator perturbation
    (n=148k het: 61 -> 64 iterations)."""

    def _pair(self):
        from prealps_tpu.core.generators import elasticity3d

        nel = (4, 3, 3)
        a = elasticity3d(*nel)
        kw = dict(nparts=4, br=3, dtype=np.float32, max_deflation=8)
        lor32 = build_scalable_lorasc(a, factor_store="f32", **kw)
        lorbf = build_scalable_lorasc(a, factor_store="bf16", **kw)
        return lor32, lorbf

    def test_bf16_close_to_f32_and_output_dtype(self, rng):
        lor32, lorbf = self._pair()
        assert lorbf.operands["aii_linv"].dtype == jnp.bfloat16
        assert lorbf.operands["agg_moff"].dtype == jnp.bfloat16
        r = jnp.asarray(
            rng.standard_normal((2, 3, lor32.plan.nrb)).astype(np.float32))
        w32 = np.asarray(lor32.apply(r))
        wbf_dev = lorbf.apply(r)
        assert wbf_dev.dtype == jnp.float32   # vectors stay f32
        wbf = np.asarray(wbf_dev)
        rel = np.max(np.abs(w32 - wbf)) / np.max(np.abs(w32))
        assert rel < 5e-2, rel

    def test_bf16_apply_stays_symmetric(self, rng):
        """L~^-T L~^-1 is exactly SPD for ANY stored factors — the CG-safety
        argument for storage-precision freedom. Verify <r1, M r2> = <r2, M r1>
        to f32 roundoff on the bf16 build."""
        _, lorbf = self._pair()
        nrb = lorbf.plan.nrb
        r1 = rng.standard_normal((1, 3, nrb)).astype(np.float32)
        r2 = rng.standard_normal((1, 3, nrb)).astype(np.float32)
        m1 = np.asarray(lorbf.apply(jnp.asarray(r1)))
        m2 = np.asarray(lorbf.apply(jnp.asarray(r2)))
        s12 = float(np.sum(r1 * m2))
        s21 = float(np.sum(r2 * m1))
        denom = max(abs(s12), abs(s21), 1e-30)
        assert abs(s12 - s21) / denom < 1e-4, (s12, s21)

    def test_unknown_factor_store_raises(self):
        from prealps_tpu.core.generators import elasticity3d

        a = elasticity3d(3, 3, 3)
        with pytest.raises(ValueError, match="factor_store"):
            build_scalable_lorasc(a, nparts=2, br=3, dtype=np.float32,
                                  max_deflation=4, factor_store="f16")


class TestAStore:
    """Operator stencil-block storage precision (lorasc_stencil a_store).

    bf16 A is safe ONLY on the preconditioner side: M's sweep SpMMs may ride
    a 4e-3-perturbed A (any symmetric perturbation of M's internals keeps CG
    valid), but the ITERATION operator must stay f32 — an elementwise 4e-3
    rounding exceeds λ_min of the scaled operator, bf16(A) goes indefinite,
    and CG breaks down at iteration 1 (measured, het 8³). The bf16
    factor/BJ stores survive because LOCAL blocks are well-conditioned."""

    def _solve(self, a_store, rng):
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers import ECGOptions

        a = elasticity3d(8, 8, 8, heterogeneous=True)
        b = np.random.default_rng(0).standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-5, maxiter=3000, layout="tbn",
                          variant="omin")
        s = StencilLorascECG.build(
            a, nparts=4, br=3, grid=(9, 9, 8), opts=opts,
            dtype=np.float32, max_deflation=24, a_store=a_store,
            correction="deflate")
        x, info = s.solve(b)
        relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
        return s, info, relres

    def test_bf16_precond_sweep_equal_convergence(self, rng):
        s32, info32, rel32 = self._solve("f32", rng)
        sbf, infobf, relbf = self._solve("bf16", rng)
        import jax.numpy as jnp

        # the reduced copy exists and the ITERATION copy stays f32
        assert sbf.precond.operands["a_stencil_m"].blocks_t.dtype == \
            jnp.bfloat16
        assert sbf.precond.operands["a_stencil"].blocks_t.dtype == \
            jnp.float32
        assert relbf < 1e-4 and rel32 < 1e-4, (relbf, rel32)
        # equal-convergence contract: within 20% iterations of f32
        assert infobf["iters"] <= 1.2 * info32["iters"] + 2, (
            infobf["iters"], info32["iters"])

    def test_bf16_all_breaks_down_documented(self, rng):
        """bf16_all is the REJECTED configuration (kept for measurement):
        pin the failure mode so the rejection rationale stays true."""
        _, info, relres = self._solve("bf16_all", rng)
        assert bool(info.get("breakdown")) or relres > 1e-3, (info, relres)
