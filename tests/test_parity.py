"""Reference-parity tests: the JAX ECG against the f64 numpy oracle
(tests/ecg_oracle.py) on the reference's deterministic configs
(reference: README.md:53-59 — LFAT5 with e=2, elasticity3d with e=4).

Same algebra + same precision +
same split must agree to ROUNDING, not to a ±15 % band — iteration counts
are asserted within ±1 and residual histories to 1e-6 relative error over
the first half-sweep (1e-3 over three quarters; the final approach to the
tolerance is rounding-amplified in ANY f64 rerun, measured ~1e-1 relative
there between algebraically identical groupings). odir_fused records the
ENTERING residual (one fused reduction per iteration), so its history is
the plain-odir history shifted by exactly one — asserted as such.

ADAPT_BS (-r 1) now has an oracle (ecg_oracle adaptive=True, restating
ecg.c:444-497) and parity cases, including the truncation semantics that
round 3's frozen-basis implementation violated.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from prealps_tpu.core.partition import nsplit
from prealps_tpu.solvers.ecg import ECGOptions, ecg_solve
from tests.ecg_oracle import block_jacobi_oracle, contiguous_split, ecg_oracle


def _jax_ecg(a, b, t, tol, variant, m_offsets=None, maxiter=2000,
             adaptive=False):
    """Single-device JAX ECG with the same contiguous split and (optional)
    exact dense-Cholesky block Jacobi as the oracle."""
    a = sp.csr_matrix(a).astype(np.float64)
    a_d = jnp.asarray(a.toarray())

    def a_apply(p):
        return a_d @ p

    if m_offsets is not None:
        from prealps_tpu.direct.subdomain import build_block_solver

        bj = build_block_solver(a, m_offsets, rcm=False, dtype=np.float64)
        m_apply = bj.apply
    else:
        m_apply = None

    opts = ECGOptions(t=t, tol=tol, maxiter=maxiter, variant=variant,
                      adaptive=adaptive)
    res = ecg_solve(a_apply, m_apply, jnp.asarray(b), opts)
    return res


def _history(res):
    h = np.asarray(res.history)
    return h[h >= 0]


def _assert_history_tracks(h_jax, h_ref):
    """Rounding-tight early, loose only in the rounding-amplified tail."""
    k = min(len(h_jax), len(h_ref))
    rel = np.abs(h_jax[:k] - h_ref[:k]) / h_ref[:k]
    assert np.all(rel[: k // 2] <= 1e-6), float(rel[: k // 2].max())
    assert np.all(rel[: 3 * k // 4] <= 1e-3), float(rel[: 3 * k // 4].max())


CONFIGS = [
    # (name, t, variant) — the reference README runs odir (-o 0); omin covers
    # the second orthogonalisation family.
    ("odir", 2, "odir"),
    ("omin", 2, "omin"),
]


class TestLFAT5Parity:
    """LFAT5 (14×14 SPD, the reference's bundled smoke matrix), e=2."""

    @pytest.mark.parametrize("name,t,variant", CONFIGS)
    def test_iteration_count_exact(self, lfat5, name, t, variant):
        a = lfat5
        rng = np.random.default_rng(0)  # reference seeds srand(0)
        b = rng.standard_normal(a.shape[0])
        offsets = nsplit(a.shape[0], 2)
        m_or = block_jacobi_oracle(a, offsets)

        oracle = ecg_oracle(a, b, t=t, tol=1e-5, variant=variant, m_apply=m_or)
        res = _jax_ecg(a, b, t=t, tol=1e-5, variant=variant, m_offsets=offsets)

        k_ref, k_jax = oracle["iters"], int(res.iters)
        assert oracle["res"] <= 1e-5 * oracle["normb"]
        assert not bool(res.breakdown)
        assert abs(k_jax - k_ref) <= 1, (k_jax, k_ref)
        _assert_history_tracks(_history(res), oracle["history"])

    def test_fused_history_is_one_shifted_odir(self, lfat5):
        """odir_fused evaluates the stopping quantity on the ENTERING
        residual: history[i] must equal plain odir's history[i-1] to
        rounding, and the count is exactly one higher."""
        a = lfat5
        rng = np.random.default_rng(0)
        b = rng.standard_normal(a.shape[0])
        offsets = nsplit(a.shape[0], 2)
        m_or = block_jacobi_oracle(a, offsets)
        oracle = ecg_oracle(a, b, t=2, tol=1e-5, variant="odir", m_apply=m_or)
        res = _jax_ecg(a, b, t=2, tol=1e-5, variant="odir_fused",
                       m_offsets=offsets)
        k_ref, k_jax = oracle["iters"], int(res.iters)
        assert k_jax - k_ref in (0, 1), (k_jax, k_ref)
        _assert_history_tracks(_history(res)[1:], oracle["history"])

    def test_adaptive_matches_oracle(self, lfat5):
        """-r 1 parity (reference ecg.c:444-497): LFAT5 reduces t=2 → 1 near
        convergence and must land on the SAME iteration count and final
        block size as the oracle (round 3's frozen-basis form stalled at
        maxiter here; truncation matches)."""
        a = lfat5
        rng = np.random.default_rng(0)
        b = rng.standard_normal(a.shape[0])
        offsets = nsplit(a.shape[0], 2)
        m_or = block_jacobi_oracle(a, offsets)
        oracle = ecg_oracle(a, b, t=2, tol=1e-5, variant="odir",
                            m_apply=m_or, adaptive=True)
        res = _jax_ecg(a, b, t=2, tol=1e-5, variant="odir",
                       m_offsets=offsets, adaptive=True)
        assert oracle["res"] <= 1e-5 * oracle["normb"]
        assert int(res.res <= 1e-5 * oracle["normb"])
        assert abs(int(res.iters) - oracle["iters"]) <= 1, (
            int(res.iters), oracle["iters"])
        assert int(res.bs) == int(oracle["bs_history"][-1])
        # the reduction schedule itself must match (same iteration, same t1)
        _assert_history_tracks(_history(res), oracle["history"])

    def test_solution_matches_direct(self, lfat5):
        a = lfat5
        rng = np.random.default_rng(0)
        b = rng.standard_normal(a.shape[0])
        offsets = nsplit(a.shape[0], 2)
        res = _jax_ecg(
            a, b, t=2, tol=1e-9, variant="odir", m_offsets=offsets, maxiter=200
        )
        x = np.asarray(res.x)
        import scipy.sparse.linalg as spla

        x_ref = spla.spsolve(sp.csc_matrix(a), b)
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-6


class TestElasticityParity:
    """Generated elasticity3d (the reference's elasticity3d_12x10x10_var
    analog; reference config: -o 0 -r 0 -e 4 over 8 process panels)."""

    @pytest.mark.parametrize("variant", ["odir", "omin"])
    def test_iteration_count_exact_e4(self, ela_small, variant):
        a = ela_small
        rng = np.random.default_rng(11)  # reference test_lorasc seeds srand(11)
        b = rng.standard_normal(a.shape[0])
        offsets = nsplit(a.shape[0], 8)  # 8 ranks → 8 BJ blocks
        m_or = block_jacobi_oracle(a, offsets)

        oracle = ecg_oracle(
            a, b, t=4, tol=1e-5, variant=variant, m_apply=m_or, maxiter=2000
        )
        res = _jax_ecg(
            a, b, t=4, tol=1e-5, variant=variant, m_offsets=offsets
        )
        k_ref, k_jax = oracle["iters"], int(res.iters)
        assert oracle["res"] <= 1e-5 * oracle["normb"], "oracle must converge"
        assert not bool(res.breakdown)
        assert abs(k_jax - k_ref) <= 1, (k_jax, k_ref)
        _assert_history_tracks(_history(res), oracle["history"])

    def test_fused_one_shifted_odir_e4(self, ela_small):
        """odir_fused is the default formulation; its history must be
        the oracle's plain-odir history shifted by exactly one."""
        a = ela_small
        rng = np.random.default_rng(11)
        b = rng.standard_normal(a.shape[0])
        offsets = nsplit(a.shape[0], 8)
        m_or = block_jacobi_oracle(a, offsets)
        oracle = ecg_oracle(
            a, b, t=4, tol=1e-5, variant="odir", m_apply=m_or, maxiter=2000
        )
        res = _jax_ecg(
            a, b, t=4, tol=1e-5, variant="odir_fused", m_offsets=offsets
        )
        k_ref, k_jax = oracle["iters"], int(res.iters)
        assert k_jax - k_ref in (0, 1), (k_jax, k_ref)
        _assert_history_tracks(_history(res)[1:], oracle["history"])

    def test_adaptive_schedule_matches_oracle_e4(self, ela_small):
        """-r 1 on elasticity: the reference's SVD test mis-triggers on this
        problem (directions drop while the residual is still ~1e4× the
        target and convergence crawls at bs=1) — PARITY means reproducing
        exactly that schedule, capped, not fixing it. Asserted: identical
        residual trajectory over the capped window and the same final bs."""
        a = ela_small
        rng = np.random.default_rng(11)
        b = rng.standard_normal(a.shape[0])
        offsets = nsplit(a.shape[0], 8)
        m_or = block_jacobi_oracle(a, offsets)
        cap = 120
        oracle = ecg_oracle(a, b, t=4, tol=1e-5, variant="odir",
                            m_apply=m_or, maxiter=cap, adaptive=True)
        res = _jax_ecg(a, b, t=4, tol=1e-5, variant="odir",
                       m_offsets=offsets, maxiter=cap, adaptive=True)
        assert int(res.iters) == oracle["iters"] == cap
        assert int(res.bs) == int(oracle["bs_history"][-1])
        # trajectory parity over the PRE-collapse window only: once the
        # direction block collapses (~iteration 50 here) the stalled
        # recurrence is rounding-chaotic and ANY two f64 groupings diverge
        _assert_history_tracks(_history(res)[:40], oracle["history"][:40])

    def test_enlarging_cuts_iterations(self, ela_small):
        """t=4 must converge in (well) fewer iterations than t=1 — the core
        enlarged-Krylov claim the reference's Fig 1 documents."""
        a = ela_small
        rng = np.random.default_rng(11)
        b = rng.standard_normal(a.shape[0])
        offsets = nsplit(a.shape[0], 8)
        m_or = block_jacobi_oracle(a, offsets)
        k1 = ecg_oracle(a, b, t=1, tol=1e-5, variant="odir", m_apply=m_or,
                        maxiter=2000)["iters"]
        k4 = ecg_oracle(a, b, t=4, tol=1e-5, variant="odir", m_apply=m_or,
                        maxiter=2000)["iters"]
        assert k4 < k1
