"""Stress tests for the adaptive-reduction and stall heuristics
(cases where ADAPT_BS must fire and where the stall guard must NOT fire;
reference: src/solvers/ecg.c:361-393,444-497 ADAPT_BS)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from prealps_tpu.solvers.ecg import ECGOptions, ecg_solve


def _dense_apply(a):
    a_d = jnp.asarray(a.toarray() if sp.issparse(a) else a)
    return lambda p: a_d @ p


class TestAdaptiveReduction:
    def test_rank_deficient_split_triggers_reduction(self, poisson_small):
        """b supported on only part of the domain makes some R0 split columns
        zero — the adaptive path must drop those directions and still
        converge (reference ADAPT_BS semantics)."""
        a = poisson_small
        n = a.shape[0]
        b = np.zeros(n)
        b[: n // 4] = np.random.default_rng(0).standard_normal(n // 4)
        t = 8  # contiguous split: 6 of 8 groups get an all-zero rhs chunk
        for variant in ("omin", "odir", "odir_fused"):
            opts = ECGOptions(t=t, tol=1e-8, maxiter=800, variant=variant,
                              adaptive=True)
            res = ecg_solve(_dense_apply(a), None, jnp.asarray(b), opts)
            assert not bool(res.breakdown), variant
            assert float(res.res) <= 1e-8 * float(res.normb), variant
            assert int(res.bs) < t, (variant, int(res.bs))

    def test_full_rank_adaptive_reaches_tol_band(self, poisson_small):
        """A generic rhs with adaptive on: ADAPT_BS drops directions whose
        alpha contribution falls below red_tol = tol·normb/√t (the
        reference's formula, ecg.c:420), which bounds the attainable residual
        at a small multiple of tol·normb. Assert that band, that reduction
        actually fired, and that the stall guard stops the resulting plateau
        instead of burning maxiter."""
        a = poisson_small
        rng = np.random.default_rng(1)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=4, tol=1e-4, maxiter=2000, variant="odir_fused",
                          adaptive=True, stall_window=60)
        res = ecg_solve(_dense_apply(a), None, jnp.asarray(b), opts)
        assert not bool(res.breakdown)
        assert int(res.bs) < 4, "reduction should fire near convergence"
        assert float(res.res) <= 5e-4 * float(res.normb)
        # truncation-style reduction (round-4 reference-parity fix) reaches
        # the plateau a little later than the old frozen-basis form did;
        # the guard still must cut WELL below maxiter=2000
        assert int(res.iters) < 800, "stall guard must stop the plateau"

    def test_disjoint_support_split_omin_adaptive(self):
        """Disjoint-support split columns on a 1-D Laplacian: the numpy
        oracle shows the reference algorithm itself struggles here (omin
        breaks down at dpotrf, odir stagnates ~1e-3). Our omin+adaptive must
        CONVERGE (rank-revealing pivoted-Cholesky path), and the odir family
        must at least stay finite without breakdown — strictly better than
        the reference's abort."""
        n = 128
        a = sp.diags(
            [np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.0)],
            [-1, 0, 1],
        ).tocsr()
        b = np.zeros(n)
        b[: n // 4] = 1.0
        b[n // 4: n // 2] = 1.0
        opts = ECGOptions(t=4, tol=1e-10, maxiter=600, variant="omin",
                          adaptive=True)
        res = ecg_solve(_dense_apply(a), None, jnp.asarray(b), opts)
        assert not bool(res.breakdown)
        assert float(res.res) <= 1e-10 * float(res.normb)

        opts2 = ECGOptions(t=4, tol=1e-10, maxiter=100, variant="odir_fused",
                           adaptive=True)
        res2 = ecg_solve(_dense_apply(a), None, jnp.asarray(b), opts2)
        assert not bool(res2.breakdown)
        assert np.all(np.isfinite(np.asarray(res2.x)))


class TestStallGuard:
    def test_slow_geometric_convergence_not_stalled(self):
        """A 1-D Laplacian converges slowly (rate ≈ 1 − 2/√κ per iteration)
        but steadily — the stall guard must NOT stop it before tol."""
        n = 200
        a = sp.diags(
            [np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.0)],
            [-1, 0, 1],
        ).tocsr()
        rng = np.random.default_rng(0)
        b = rng.standard_normal(n)
        opts = ECGOptions(t=1, tol=1e-8, maxiter=2000, variant="odir_fused",
                          stall_window=60)
        res = ecg_solve(_dense_apply(a), None, jnp.asarray(b), opts)
        assert float(res.res) <= 1e-8 * float(res.normb), (
            "stall guard fired on a converging run",
            int(res.iters), float(res.res / res.normb),
        )

    def test_true_floor_stalls_before_maxiter(self, poisson_small):
        """tol below the attainable floor: the guard must stop the loop well
        before maxiter (this is its reason to exist — the reference burns
        maxiter here)."""
        a = poisson_small
        rng = np.random.default_rng(0)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=2, tol=1e-30, maxiter=5000, variant="odir_fused",
                          stall_window=60)
        res = ecg_solve(_dense_apply(a), None, jnp.asarray(b), opts)
        assert int(res.iters) < 2000, int(res.iters)
        # and it stopped AT the floor, i.e. fully converged in f64 terms
        assert float(res.res) <= 1e-10 * float(res.normb)

    def test_stall_rtol_knob(self, poisson_small):
        """A huge stall_rtol makes every iteration 'no progress': the run
        stops after exactly stall_window iterations."""
        a = poisson_small
        rng = np.random.default_rng(0)
        b = rng.standard_normal(a.shape[0])
        opts = ECGOptions(t=2, tol=1e-12, maxiter=500, variant="odir_fused",
                          stall_window=10, stall_rtol=0.999999)
        res = ecg_solve(_dense_apply(a), None, jnp.asarray(b), opts)
        assert int(res.iters) <= 12, int(res.iters)


class TestNearTolStall:
    """Within 2x of the tolerance a plateau is the f32 floor: each of its
    iterations counts ten times towards stall_window."""

    @pytest.mark.parametrize("res, tol, step", [
        (1.0, 0.6, 10),    # no progress, best within 2x of tol*normb
        (1.0, 1e-3, 1),    # no progress far from tol: a block-CG plateau
        (0.5, 0.6, -3),    # progress resets the counter (3 -> 0)
    ])
    def test_stall_step(self, res, tol, step):
        from types import SimpleNamespace

        from prealps_tpu.solvers.ecg import _track_stall

        state = SimpleNamespace(best_res=jnp.float32(1.0),
                                stall=jnp.int32(3))
        opts = ECGOptions(tol=tol, stall_window=250)
        best, stall = _track_stall(state, jnp.float32(res), opts,
                                   jnp.float32(1.0))
        assert float(best) == min(1.0, res)
        assert int(stall) == 3 + step
