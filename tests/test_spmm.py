"""SpMM kernels vs scipy reference (SURVEY.md §4: kernel-level verification)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from prealps_tpu.ops.formats import csr_to_block_ell, csr_to_ell
from prealps_tpu.ops.spmm import block_ell_spmm, ell_spmm


def _random_csr(rng, n, density=0.05):
    a = sp.random(n, n, density=density, random_state=np.random.RandomState(7))
    a = a + a.T + sp.eye(n) * 2
    return sp.csr_matrix(a)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    a = _random_csr(rng, 200)
    x = rng.standard_normal((200, 4))
    return a, x


class TestEll:
    def test_matches_scipy(self, problem):
        a, x = problem
        ae = csr_to_ell(a)
        y = ell_spmm(ae, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-12)

    def test_elasticity(self, ela_small, rng):
        x = rng.standard_normal((ela_small.shape[0], 8))
        ae = csr_to_ell(ela_small)
        y = ell_spmm(ae, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), ela_small @ x, rtol=1e-10)


class TestBlockEll:
    @pytest.mark.parametrize("bm,bk", [(8, 128), (8, 32), (16, 64)])
    def test_matches_scipy(self, problem, bm, bk):
        a, x = problem
        ab = csr_to_block_ell(a, bm=bm, bk=bk)
        n_pad, ncols_pad = ab.shape
        xp = np.zeros((ncols_pad, x.shape[1]))
        xp[: x.shape[0]] = x
        y = block_ell_spmm(ab, jnp.asarray(xp))
        np.testing.assert_allclose(np.asarray(y)[: a.shape[0]], a @ x, rtol=1e-12)

    def test_fill_ratio_reasonable_after_rcm(self, ela_small):
        from prealps_tpu.core.partition import permute, rcm_order

        p = rcm_order(ela_small)
        ap = permute(ela_small, p)
        ab = csr_to_block_ell(ap, bm=8, bk=128)
        assert ab.fill_ratio < 40  # sanity: padding under control after RCM


class TestStencil:
    def test_scan_matches_scipy(self, ela_small, rng):
        from prealps_tpu.core.scaling import sym_rac_scaling
        from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
        from prealps_tpu.ops.spmm import (
            panel_from_lane_major,
            panel_to_lane_major,
            stencil_bsr_spmm_t,
        )

        a, _ = sym_rac_scaling(ela_small)
        sb = csr_to_stencil_bsr_t(a, br=3)
        x = rng.standard_normal((a.shape[0], 4))
        xt = panel_to_lane_major(jnp.asarray(x), 3)
        y = panel_from_lane_major(stencil_bsr_spmm_t(sb, xt))
        np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-10, atol=1e-12)


class TestDiaEll:
    def test_matches_scipy_banded_plus_noise(self, rng):
        import scipy.sparse as sp

        from prealps_tpu.ops.formats import csr_to_dia_ell
        from prealps_tpu.ops.spmm import dia_ell_spmm, spmm

        n = 300
        band = sp.diags(
            [rng.standard_normal(n - abs(k)) for k in (-7, -1, 0, 1, 7)],
            offsets=[-7, -1, 0, 1, 7], shape=(n, n), format="csr",
        )
        noise = sp.random(n, n, density=0.002, random_state=7, format="csr")
        a = sp.csr_matrix(band + noise)
        d = csr_to_dia_ell(a, min_fill=0.5)
        assert d.rem is not None           # the noise must land in ELL
        assert len(d.offsets) == 5         # the five dense bands promoted
        x = rng.standard_normal((n, 4))
        y = np.asarray(dia_ell_spmm(d, jnp.asarray(x)))
        np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)
        y2 = np.asarray(spmm(d, jnp.asarray(x)))
        np.testing.assert_allclose(y2, a @ x, rtol=1e-12, atol=1e-12)

    def test_rcm_elasticity_band_complete(self, ela_small, rng):
        # after RCM the elasticity operator is band-dominated; with a low
        # promotion threshold every entry lands on a diagonal (rem None or
        # tiny) and the product stays exact
        import scipy.sparse as sp

        from prealps_tpu.core.partition import rcm_order
        from prealps_tpu.ops.formats import csr_to_dia_ell
        from prealps_tpu.ops.spmm import dia_ell_spmm

        a = sp.csr_matrix(ela_small)
        p = rcm_order(a)
        ap = sp.csr_matrix(a[p][:, p])
        d = csr_to_dia_ell(ap, min_fill=0.02)
        dia_cap = d.diags.shape[0] * d.diags.shape[1]
        assert dia_cap >= 0.5 * ap.nnz     # most nnz promoted to diagonals
        x = rng.standard_normal((ap.shape[0], 3))
        y = np.asarray(dia_ell_spmm(d, jnp.asarray(x)))
        np.testing.assert_allclose(y, ap @ x, rtol=1e-10, atol=1e-10)

    def test_pure_band_no_remainder(self, rng):
        import scipy.sparse as sp

        from prealps_tpu.ops.formats import csr_to_dia_ell
        from prealps_tpu.ops.spmm import dia_ell_spmm

        n = 128
        a = sp.diags(
            [np.full(n - 1, 2.0), np.full(n, 5.0), np.full(n - 1, 2.0)],
            offsets=[-1, 0, 1], format="csr",
        )
        d = csr_to_dia_ell(sp.csr_matrix(a))
        assert d.rem is None
        x = rng.standard_normal((n, 2))
        y = np.asarray(dia_ell_spmm(d, jnp.asarray(x)))
        np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)

    def test_auto_order_prefers_natural_on_grid(self, ela_small, rng):
        import scipy.sparse as sp

        from prealps_tpu.ops.formats import csr_to_dia_ell_auto, dia_coverage
        from prealps_tpu.ops.spmm import dia_ell_spmm

        a = sp.csr_matrix(ela_small)
        assert dia_coverage(a, 0.05) > 0.9
        d, perm = csr_to_dia_ell_auto(a, min_fill=0.05)
        assert perm is None                      # natural order kept
        x = rng.standard_normal((a.shape[0], 2))
        y = np.asarray(dia_ell_spmm(d, jnp.asarray(x)))
        np.testing.assert_allclose(y, a @ x, rtol=1e-10, atol=1e-10)

    def test_auto_order_rcm_on_shuffled(self, rng):
        # randomly permuted band matrix: natural coverage is poor, RCM
        # recovers the band
        import scipy.sparse as sp

        from prealps_tpu.ops.formats import csr_to_dia_ell_auto
        from prealps_tpu.ops.spmm import dia_ell_spmm

        n = 400
        a = sp.diags(
            [np.full(n - 1, -1.0), np.full(n, 4.0), np.full(n - 1, -1.0)],
            offsets=[-1, 0, 1], format="csr",
        )
        p = rng.permutation(n)
        ashuf = sp.csr_matrix(a[p][:, p])
        d, perm = csr_to_dia_ell_auto(ashuf, min_fill=0.2)
        assert perm is not None
        x = rng.standard_normal((n, 2))
        y_perm = np.asarray(dia_ell_spmm(d, jnp.asarray(x[perm])))
        # undo the permutation on the output
        y = np.empty_like(y_perm)
        y[...] = y_perm
        ref = (ashuf @ x)[perm]
        np.testing.assert_allclose(y, ref, rtol=1e-10, atol=1e-10)


class TestAutoFormat:
    """fmt='auto' structure extraction (the mkl_dcsrmm 'any CSR' role,
    reference utils/cplm_light/cplm_kernels.c:620-671, as a product
    path)."""

    def _geometric(self, rng, npts=600, rad=0.25, spd=True):
        """k-NN-ish geometric graph on random 3-D points, SHUFFLED so the
        natural order carries no locality (the Morton path must earn it)."""
        pts = rng.random((npts, 3))
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        adj = (d2 < rad * rad)
        a = sp.csr_matrix(adj.astype(np.float64))
        a = a + a.T
        if spd:
            lap = sp.diags(np.asarray(a.sum(axis=1)).ravel() + 1.0) - a
            a = sp.csr_matrix(lap)
        pm = rng.permutation(npts)
        return sp.csr_matrix(a[pm][:, pm])

    def test_detect_stencil(self, ela_small):
        from prealps_tpu.ops.formats import detect_format

        fmt, info = detect_format(ela_small, br=3)
        assert fmt == "stencil", info

    def test_detect_dia(self, rng):
        from prealps_tpu.ops.formats import detect_format

        n = 100  # tridiagonal, n % 3 != 0: not a br=3 stencil, pure DIA
        a = sp.diags([np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
                     [-1, 0, 1]).tocsr()
        fmt, info = detect_format(a, br=3)
        assert fmt == "dia", info

    def test_detect_morton_block_ell(self, rng):
        from prealps_tpu.ops.formats import detect_format

        a = self._geometric(rng)
        fmt, info = detect_format(a, br=3)
        assert fmt == "block_ell_morton", info
        assert info["bell_fill_morton"] > info["bell_fill_natural"], info
        assert "perm" in info

    def test_detect_ell_on_random(self, rng):
        from prealps_tpu.ops.formats import detect_format

        n = 400
        a = sp.random(n, n, density=0.01, random_state=7, format="csr")
        a = a + a.T + sp.eye(n)
        fmt, info = detect_format(sp.csr_matrix(a), br=3)
        assert fmt == "ell", info

    def test_auto_solve_geometric_end_to_end(self, rng):
        """fmt='auto' on a shuffled geometric SPD matrix: the Morton
        pre-permutation must be transparent (x answers the ORIGINAL
        ordering)."""
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers.ecg import ECGOptions

        a = self._geometric(rng)
        n = a.shape[0]
        b = rng.standard_normal(n)
        solver = DistributedECG.build(
            a, nshards=1, opts=ECGOptions(t=4, tol=1e-8, maxiter=2000),
            precond="block_jacobi", fmt="auto", dtype=np.float64,
        )
        assert solver.pre_perm is not None
        x, info = solver.solve(b)
        relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
        assert relres < 1e-6, (relres, info)

    def test_auto_solve_stencil_end_to_end(self, ela_small, rng):
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers.ecg import ECGOptions

        a = sp.csr_matrix(ela_small)
        b = rng.standard_normal(a.shape[0])
        solver = DistributedECG.build(
            a, nshards=1, opts=ECGOptions(t=4, tol=1e-8, maxiter=4000),
            precond="block_jacobi", fmt="auto", dtype=np.float64,
        )
        assert solver.fmt_info["chosen"] == "stencil"
        x, info = solver.solve(b)
        relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
        assert relres < 1e-6, (relres, info)

    def test_detect_banded_prefers_dia_over_blockstencil(self, rng):
        """A SCALAR-banded matrix also passes the br=3 stencil test but at
        ~1/3 block fill — DIA moves a third of the bytes."""
        from prealps_tpu.ops.formats import detect_format

        n = 60_000
        offs = [0, 1, 2, 3, 5, 8, 13, 21, 34]
        mats = [sp.diags(rng.random(n - o) + 0.1, o, shape=(n, n))
                for o in offs]
        band = sum(mats[1:], mats[0])
        band = (band + band.T).tocsr()
        band = band + sp.diags(np.asarray(abs(band).sum(axis=1)).ravel())
        fmt, info = detect_format(sp.csr_matrix(band), br=3)
        assert fmt == "dia", info

    def test_detect_dia_rcm_returns_perm_and_build_applies_it(self, rng):
        """Shuffled banded matrix: coverage is only recoverable under RCM —
        detection must return the permutation and the driver must APPLY it
        (round-4 review: the old code chose 'dia' on RCM coverage but built
        on the unpermuted matrix)."""
        from prealps_tpu.ops.formats import detect_format
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers.ecg import ECGOptions

        n = 1200
        band = sp.diags(
            [np.ones(n - 1), 4.0 * np.ones(n), np.ones(n - 1)],
            [-1, 0, 1]).tocsr()
        pm = rng.permutation(n)
        a = sp.csr_matrix(band[pm][:, pm])
        fmt, info = detect_format(a, br=3)
        assert fmt == "dia_rcm", info
        assert "perm" in info

        b = rng.standard_normal(n)
        solver = DistributedECG.build(
            a, nshards=1, opts=ECGOptions(t=2, tol=1e-10, maxiter=500),
            precond="none", fmt="auto", dtype=np.float64, scale=False,
        )
        assert solver.pre_perm is not None
        assert solver.fmt_info["chosen"] == "dia_rcm"
        x, _ = solver.solve(b)
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8

    def test_auto_honors_explicit_valid_layout(self, ela_small, rng):
        """auto_layout=False: an explicitly chosen VALID layout survives
        detection (round-4 review: fmt=auto silently overwrote it)."""
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers.ecg import ECGOptions

        a = sp.csr_matrix(ela_small)
        solver = DistributedECG.build(
            a, nshards=1,
            opts=ECGOptions(t=4, tol=1e-8, maxiter=2000, layout="tbn"),
            precond="block_jacobi", fmt="auto", dtype=np.float64,
            auto_layout=False,
        )
        assert solver.opts.layout == "tbn"   # valid for stencil: kept
        b = rng.standard_normal(a.shape[0])
        x, _ = solver.solve(b)
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-6

    def test_auto_dia_rcm_multishard_solve(self, rng):
        """fmt=auto + RCM-recovered DIA over 4 shards: the pre-permutation
        composes with the row layout and halo plans."""
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers.ecg import ECGOptions

        n = 2400
        band = sp.diags(
            [np.ones(n - 3), np.ones(n - 1), 5.0 * np.ones(n),
             np.ones(n - 1), np.ones(n - 3)],
            [-3, -1, 0, 1, 3]).tocsr()
        pm = rng.permutation(n)
        a = sp.csr_matrix(band[pm][:, pm])
        b = rng.standard_normal(n)
        solver = DistributedECG.build(
            a, nshards=4, opts=ECGOptions(t=2, tol=1e-10, maxiter=400),
            precond="block_jacobi", fmt="auto", dtype=np.float64,
        )
        assert solver.fmt_info["chosen"] == "dia_rcm"
        x, info = solver.solve(b)
        relres = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
        assert relres < 1e-8, (relres, info)


@pytest.mark.parametrize("fmt, store", [
    ("ell", np.float32), ("stencil", np.float32), ("stencil_t", np.float32),
    ("stencil_t", "bf16"),
])
def test_rounding_remainder_restores_f64_matrix(fmt, store):
    """stored(A) + A_lo reproduces the f64 operator far below f32 rounding,
    in the layout each solver applies it in."""
    import ml_dtypes

    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.ops.formats import (
        csr_to_stencil_bsr,
        csr_to_stencil_bsr_t,
        rounding_remainder,
    )

    store_np = ml_dtypes.bfloat16 if store == "bf16" else store
    a = elasticity3d(4, 3, 3, heterogeneous=True)
    if fmt == "ell":
        stored = csr_to_ell(a, dtype=np.float32)
        v64 = np.asarray(csr_to_ell(a, dtype=np.float64).vals)
        v_st = np.asarray(stored.vals, np.float64)
    else:
        conv = csr_to_stencil_bsr if fmt == "stencil" else csr_to_stencil_bsr_t
        stored = conv(a, br=3, dtype=np.float32)
        v64 = np.asarray(csr_to_stencil_bsr_t(a, br=3, dtype=np.float64)
                         .blocks_t)
        v_st = v64.astype(store_np).astype(np.float64)
    lo = np.asarray(rounding_remainder(a, stored, store_dtype=store_np))
    assert lo.dtype == np.float32 and lo.shape == v64.shape
    scale = np.abs(v64).max()
    assert np.abs(v64 - v_st).max() > 1e-9 * scale   # rounding is there
    # an f32 A_lo carries 24 bits of a remainder 2^-8 (bf16) or 2^-24
    # (f32) the size of A
    bound = 1e-9 if store == "bf16" else 1e-12
    assert np.abs(v64 - (v_st + lo)).max() <= bound * scale
