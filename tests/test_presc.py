"""PRESC preconditioner tests (reference: src/preconditioners/presc.c)."""

import numpy as np
import pytest
import scipy.linalg

from prealps_tpu.api import ECGSolver
from prealps_tpu.core.partition import block_arrow_structure, permute
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.precond.presc import (
    build_presc,
    local_schur_complements,
    separator_owners,
)
from prealps_tpu.precond.lorasc import schur_complement_dense
from prealps_tpu.solvers import ECGOptions


def _relres(a, x, b):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


class TestLocalSchur:
    def test_local_schur_spd_and_dominates_global(self, ela_small):
        a, _ = sym_rac_scaling(ela_small)
        arrow = block_arrow_structure(a, 4)
        ap = permute(a, arrow.perm)
        owner = separator_owners(ap, arrow)
        blocks, sep_off = local_schur_complements(ap, arrow, owner)
        for b in blocks:
            if b.size:
                # exact local Schur complements of an SPD matrix are SPD
                np.linalg.cholesky(b)

    def test_owner_assignment_covers_all(self, ela_small):
        a, _ = sym_rac_scaling(ela_small)
        arrow = block_arrow_structure(a, 4)
        ap = permute(a, arrow.perm)
        owner = separator_owners(ap, arrow)
        assert owner.shape[0] == arrow.sep_size
        assert owner.min() >= 0 and owner.max() < 4


class TestPrescSolve:
    @pytest.mark.parametrize("kind", ["ssloc", "saloc"])
    def test_ecg_presc_converges(self, ela_small, rng, kind):
        b = rng.standard_normal(ela_small.shape[0])
        opts = ECGOptions(t=2, tol=1e-6, maxiter=3000, variant="odir_fused")
        solver = ECGSolver.build(
            ela_small, opts=opts, precond="presc", nparts=4, eigs_kind=kind
        )
        x, info = solver.solve(b)
        assert not info["breakdown"]
        assert _relres(ela_small, x, b) < 1e-5

    def test_presc_beats_block_jacobi(self, ela_small, rng):
        b = rng.standard_normal(ela_small.shape[0])
        opts = ECGOptions(t=2, tol=1e-6, maxiter=4000, variant="odir_fused")
        s_bj = ECGSolver.build(ela_small, opts=opts, precond="block_jacobi", nblocks=4)
        s_pr = ECGSolver.build(ela_small, opts=opts, precond="presc", nparts=4)
        _, i_bj = s_bj.solve(b)
        x, i_pr = s_pr.solve(b)
        assert _relres(ela_small, x, b) < 1e-5
        assert i_pr["iters"] < i_bj["iters"]


class TestPrescLanczos:
    def test_presc_lanczos_converges(self, ela_small, rng):
        b = rng.standard_normal(ela_small.shape[0])
        opts = ECGOptions(t=2, tol=1e-6, maxiter=3000, variant="odir_fused")
        solver = ECGSolver.build(
            ela_small, opts=opts, precond="presc", nparts=4,
            eig_method="lanczos",
        )
        x, info = solver.solve(b)
        assert _relres(ela_small, x, b) < 1e-5


class TestBandedLocalSchur:
    def test_matches_dense_local_schur(self, ela_small):
        """The device banded partial factorization reproduces the host
        dense local Schur complements exactly (the at-scale PARDISO
        iparm[35] path wired into PRESC)."""
        import scipy.sparse as sp

        from prealps_tpu.core.partition import block_arrow_structure, permute
        from prealps_tpu.precond.presc import (
            local_schur_complements,
            local_schur_complements_banded,
            separator_owners,
        )

        a = sp.csr_matrix(ela_small)
        arrow = block_arrow_structure(a, 4)
        ap = permute(a, arrow.perm)
        owner = separator_owners(ap, arrow)
        sep_order = np.argsort(owner, kind="stable")
        ni = arrow.sep_start
        perm2 = np.concatenate([np.arange(ni), ni + sep_order])
        ap2 = permute(ap, perm2)
        from prealps_tpu.core.partition import BlockArrowStruct

        arrow2 = BlockArrowStruct(
            perm=arrow.perm[perm2],
            interior_offsets=arrow.interior_offsets,
            sep_start=ni, n=arrow.n, part=arrow.part,
        )
        owner2 = owner[sep_order]

        ref_blocks, ref_off = local_schur_complements(ap2, arrow2, owner2)
        dev_blocks, dev_off = local_schur_complements_banded(
            ap2, arrow2, owner2)
        np.testing.assert_array_equal(ref_off, dev_off)
        for rb, db in zip(ref_blocks, dev_blocks):
            assert rb.shape == db.shape
            if rb.size:
                np.testing.assert_allclose(db, rb, rtol=1e-8, atol=1e-9)


class TestScalablePresc:
    """PRESC at the banded scale (round-3): the SSLOC pencil wired through
    the scalable LORASC machinery — device-assembled exact local Schur
    complements + thick-restart Lanczos (reference: presc.c:239-316 +
    mkl_pardiso_solver.c:131-141 partial-factorization Schur)."""

    def test_device_sloc_matches_scipy(self):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.core.gridpart import (
            collapse_to_nodes,
            grid_box_partition,
        )
        from prealps_tpu.core.scaling import sym_rac_scaling
        from prealps_tpu.precond.lorasc_scale import (
            _sep_node_owners,
            build_scalable_lorasc,
            plan_arrow_bands,
        )

        a = elasticity3d(8, 8, 8)
        a, _ = sym_rac_scaling(a)
        br, gx, gy, gz = 3, 9, 9, 8
        node_graph = collapse_to_nodes(a, br)
        node_part, in_sep = grid_box_partition(gx, gy, gz, 4)
        plan = plan_arrow_bands(node_graph, node_part, in_sep, 4, br)
        sl = build_scalable_lorasc(
            a, nparts=4, br=br, grid=(gx, gy, gz), dtype=np.float64,
            pencil="sloc", max_deflation=16,
        )
        owners = _sep_node_owners(node_graph, plan, plan.part_arr)
        sloc_dev = np.asarray(sl.operands["sloc"])
        for p in range(2):
            own = [int(plan.sep_nodes[j]) for j in range(plan.nsn)
                   if owners[j] == p]
            own_dofs = np.concatenate(
                [np.arange(br) + u * br for u in own])
            int_nodes = np.flatnonzero(plan.part_arr == p)
            int_dofs = np.concatenate(
                [np.arange(br) + u * br for u in int_nodes])
            aii = a[int_dofs][:, int_dofs].tocsc()
            aig = a[int_dofs][:, own_dofs].toarray()
            agg = a[own_dofs][:, own_dofs].toarray()
            w = spla.spsolve(aii, aig)
            if sp.issparse(w):
                w = w.toarray()
            s_ref = agg - aig.T @ np.atleast_2d(np.asarray(w)).reshape(
                aig.shape)
            s_ref = 0.5 * (s_ref + s_ref.T)
            nsd = own_dofs.size
            np.testing.assert_allclose(
                sloc_dev[p][:nsd, :nsd], s_ref, rtol=1e-10, atol=1e-12)

    def test_ssloc_pencil_solves(self, rng):
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers import ECGOptions

        a = elasticity3d(8, 8, 8, heterogeneous=True)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-6, maxiter=3000,
                          variant="odir_fused", layout="tbn")
        s = StencilLorascECG.build(
            a, nparts=4, br=3, grid=(9, 9, 8), opts=opts,
            dtype=np.float64, max_deflation=48, pencil="sloc",
        )
        x, info = s.solve(b)
        relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
        assert relres < 1e-5
        assert info["deflated"] > 0
        # deflation must actually help: an undeflated run needs more iters
        s0 = StencilLorascECG.build(
            a, nparts=4, br=3, grid=(9, 9, 8), opts=opts,
            dtype=np.float64, max_deflation=1, pencil="sloc",
        )
        x0, info0 = s0.solve(b)
        assert info["iters"] < info0["iters"]


class TestScalableSaloc:
    """SALOC pencil at scale: S u = λ Aloc u with
    Aloc = blockdiag(Agg_pp) — the easier PRESC operand through the same
    device plumbing (reference: presc_eigsolve.c:249-423)."""

    def test_device_aloc_matches_scipy(self):
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.core.gridpart import (
            collapse_to_nodes,
            grid_box_partition,
        )
        from prealps_tpu.core.scaling import sym_rac_scaling
        from prealps_tpu.precond.lorasc_scale import (
            _sep_node_owners,
            build_scalable_lorasc,
            plan_arrow_bands,
        )

        a = elasticity3d(8, 8, 8)
        a, _ = sym_rac_scaling(a)
        br, gx, gy, gz = 3, 9, 9, 8
        node_graph = collapse_to_nodes(a, br)
        node_part, in_sep = grid_box_partition(gx, gy, gz, 4)
        plan = plan_arrow_bands(node_graph, node_part, in_sep, 4, br)
        sl = build_scalable_lorasc(
            a, nparts=4, br=br, grid=(gx, gy, gz), dtype=np.float64,
            pencil="saloc", max_deflation=16,
        )
        owners = _sep_node_owners(node_graph, plan, plan.part_arr)
        aloc_dev = np.asarray(sl.operands["sloc"])
        for p in range(2):
            own = [int(plan.sep_nodes[j]) for j in range(plan.nsn)
                   if owners[j] == p]
            own_dofs = np.concatenate(
                [np.arange(br) + u * br for u in own])
            agg = a[own_dofs][:, own_dofs].toarray()
            nsd = own_dofs.size
            np.testing.assert_allclose(
                aloc_dev[p][:nsd, :nsd], 0.5 * (agg + agg.T),
                rtol=1e-12, atol=1e-14)

    def test_saloc_pencil_solves(self, rng):
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers import ECGOptions

        a = elasticity3d(8, 8, 8, heterogeneous=True)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-6, maxiter=3000, layout="tbn",
                          variant="odir_fused")
        s = StencilLorascECG.build(
            a, nparts=4, br=3, grid=(9, 9, 8), opts=opts,
            dtype=np.float64, max_deflation=24, pencil="saloc",
        )
        x, info = s.solve(b)
        relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
        assert relres < 1e-5, (relres, info)

    def test_saloc_behavior_contract(self, rng):
        """Pin the SALOC pencil's expected-weak behavior so it can't
        silently regress to zero pairs or divergence (the at-scale outcome — 2 pairs / 317 iters at n=148k het, vs
        SSLOC's 97 pairs / ~130 — was recorded only in docs). SALOC is a
        WEAK pencil by construction (Aloc = blockdiag(Agg_pp) ignores the
        interior coupling S captures; the reference marks PRESC
        experimental — presc_eigsolve.c:249-423): at reduced scale with a
        window the pencil admits, it must still (a) yield at least one
        deflated pair and (b) converge within a bounded iteration count
        no worse than the undeflated sweep (measured here: 11 pairs,
        38 iters vs 45 undeflated at deflation_tol=0.3)."""
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
        from prealps_tpu.solvers import ECGOptions

        a = elasticity3d(8, 8, 8, heterogeneous=True)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-6, maxiter=3000, layout="tbn",
                          variant="odir_fused")
        s = StencilLorascECG.build(
            a, nparts=4, br=3, grid=(9, 9, 8), opts=opts,
            dtype=np.float64, max_deflation=24, pencil="saloc",
            deflation_tol=0.3,
        )
        assert s.precond.deflated >= 1, (
            "SALOC pencil yielded no pairs in a window it admits")
        x, info = s.solve(b)
        relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
        assert relres < 1e-5, (relres, info)
        assert info["iters"] <= 60, (
            "SALOC-deflated solve regressed past its iteration bound",
            info["iters"], s.precond.deflated)
