"""Generalized symmetric Lanczos eigensolver (the PARPACK role, in JAX).

Solves S u = λ B u for the smallest eigenpairs, with S SPD-symmetric and B
SPD, via Lanczos on OP = B⁻¹S in the B-inner product — the same mode-2
formulation the reference drives through PARPACK's RCI
(reference: utils/eigsolver.c:225-231 pdsaupd loop, mode 2 at :103;
ncv = 2·nev+1 at :110; deterministic constant start vector at :124-128).

Design: fixed ncv iterations inside lax.fori_loop with full
B-reorthogonalisation (V is ncv+1 columns, static shape), then an eigh of the
tridiagonal Rayleigh matrix. Everything is jittable; the operator callbacks
are closures (matrix-free, like the reference's RCI).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from prealps_tpu.ops.blockops import HIGHEST


class LanczosResult(NamedTuple):
    eigvalues: jax.Array   # (ncv,) ritz values, ascending
    eigvectors: jax.Array  # (n, ncv) B-orthonormal ritz vectors
    resid: jax.Array       # (ncv,) residual estimates |beta_ncv * y_last|
    niter: jax.Array


def lanczos_gen(
    op_apply: Callable[[jax.Array], jax.Array],   # v -> B⁻¹ S v
    b_apply: Callable[[jax.Array], jax.Array],    # v -> B v
    n: int,
    ncv: int,
    dtype=jnp.float64,
    v0: jax.Array | None = None,
) -> LanczosResult:
    """Run ncv Lanczos steps; returns all ncv Ritz pairs (ascending)."""
    if v0 is None:
        # deterministic start, mirroring the reference's fixed resid=1e-2
        v0 = jnp.full((n,), 1e-2, dtype=dtype)
    v0 = v0.astype(dtype)

    def b_norm(v):
        return jnp.sqrt(jnp.maximum(jnp.vdot(v, b_apply(v)), 0.0))

    nrm0 = b_norm(v0)
    v1 = v0 / nrm0

    v_basis = jnp.zeros((n, ncv + 1), dtype)
    v_basis = v_basis.at[:, 0].set(v1)
    alphas = jnp.zeros((ncv,), dtype)
    betas = jnp.zeros((ncv,), dtype)

    def step(j, carry):
        v_basis, alphas, betas = carry
        vj = v_basis[:, j]
        w = op_apply(vj)
        bw = b_apply(w)
        alpha = jnp.vdot(vj, bw)
        # full B-reorthogonalisation against the basis built so far
        mask = (jnp.arange(ncv + 1) <= j).astype(dtype)
        proj = jnp.einsum("nk,n->k", v_basis, bw, precision=HIGHEST) * mask
        w = w - jnp.einsum("nk,k->n", v_basis, proj, precision=HIGHEST)
        # second pass for robustness
        bw2 = b_apply(w)
        proj2 = jnp.einsum("nk,n->k", v_basis, bw2, precision=HIGHEST) * mask
        w = w - jnp.einsum("nk,k->n", v_basis, proj2, precision=HIGHEST)
        beta = b_norm(w)
        v_next = w / jnp.where(beta > 0, beta, 1.0)
        v_basis = v_basis.at[:, j + 1].set(v_next)
        alphas = alphas.at[j].set(alpha)
        betas = betas.at[j].set(beta)
        return v_basis, alphas, betas

    v_basis, alphas, betas = jax.lax.fori_loop(
        0, ncv, step, (v_basis, alphas, betas)
    )

    tri = (
        jnp.diag(alphas)
        + jnp.diag(betas[:-1], k=1)
        + jnp.diag(betas[:-1], k=-1)
    )
    theta, y = jnp.linalg.eigh(tri)
    vecs = jnp.einsum("nk,km->nm", v_basis[:, :ncv], y, precision=HIGHEST)
    resid = jnp.abs(betas[ncv - 1] * y[ncv - 1, :])
    return LanczosResult(
        eigvalues=theta, eigvectors=vecs, resid=resid, niter=jnp.int32(ncv)
    )


def lanczos_thick_restart(
    op_apply: Callable[[jax.Array], jax.Array],   # v -> B⁻¹ S v
    b_apply: Callable[[jax.Array], jax.Array],    # v -> B v
    n: int,
    ncv: int,
    nev: int,
    restarts: int = 4,
    dtype=jnp.float64,
    v0: jax.Array | None = None,
) -> LanczosResult:
    """Thick-restart Lanczos (Wu & Simon) in the B-inner product — the
    JAX analog of PARPACK's implicitly-restarted iteration
    (reference: utils/eigsolver.c:110 ncv=2·nev+1 WITH restarts, maxit=200).

    Each cycle runs the basis out to `ncv` vectors with full two-pass
    B-reorthogonalisation, Rayleigh-Ritz-es the projected matrix, keeps the
    `nkeep` smallest Ritz vectors plus the residual direction, and extends
    again. Converged pairs lock in across cycles, so a modest basis
    (ncv ≈ 2·nev) with a few restarts beats one huge single pass — and the
    converged-pair yield stops depending on one lucky Krylov run.

    All shapes static; `restarts+1` total cycles via lax.fori_loop.
    """
    if v0 is None:
        v0 = jnp.full((n,), 1e-2, dtype=dtype)
    v0 = v0.astype(dtype)
    m = ncv
    nkeep = min(max(nev + (m - nev) // 3, 1), m - 2)

    def b_norm(v):
        return jnp.sqrt(jnp.maximum(jnp.vdot(v, b_apply(v)), 0.0))

    v1 = v0 / b_norm(v0)
    v_basis = jnp.zeros((n, m + 1), dtype).at[:, 0].set(v1)
    # projected matrix: h[i, j] = <v_i, B OP v_j>, plus h[j+1, j] = beta_j
    h = jnp.zeros((m + 1, m), dtype)

    def extend(j, carry):
        """One basis-extension step writing column j of h."""
        v_basis, h = carry
        vj = v_basis[:, j]
        w = op_apply(vj)
        bw = b_apply(w)
        mask = (jnp.arange(m + 1) <= j).astype(dtype)
        proj = jnp.einsum("nk,n->k", v_basis, bw, precision=HIGHEST) * mask
        w = w - jnp.einsum("nk,k->n", v_basis, proj, precision=HIGHEST)
        bw2 = b_apply(w)
        proj2 = jnp.einsum("nk,n->k", v_basis, bw2, precision=HIGHEST) * mask
        w = w - jnp.einsum("nk,k->n", v_basis, proj2, precision=HIGHEST)
        beta = b_norm(w)
        v_next = w / jnp.where(beta > 0, beta, 1.0)
        v_basis = v_basis.at[:, j + 1].set(v_next)
        h = h.at[:, j].set(proj + proj2)   # rows > j are zero via mask
        h = h.at[j + 1, j].set(beta)
        return v_basis, h

    def rayleigh_ritz(h):
        hs = 0.5 * (h[:m, :] + h[:m, :].T)
        theta, y = jnp.linalg.eigh(hs)
        return theta, y

    def cycle(c, carry):
        v_basis, h, jstart = carry
        v_basis, h = jax.lax.fori_loop(jstart, m, extend, (v_basis, h))
        theta, y = rayleigh_ritz(h)
        s = h[m, m - 1] * y[m - 1, :]          # residual couplings
        # restart: keep nkeep smallest Ritz vectors + the residual direction
        v_keep = jnp.einsum(
            "nk,km->nm", v_basis[:, :m], y[:, :nkeep], precision=HIGHEST
        )
        v_res = v_basis[:, m]
        v_new = (
            jnp.zeros_like(v_basis)
            .at[:, :nkeep].set(v_keep)
            .at[:, nkeep].set(v_res)
        )
        h_new = (
            jnp.zeros_like(h)
            .at[jnp.arange(nkeep), jnp.arange(nkeep)].set(theta[:nkeep])
            .at[nkeep, :nkeep].set(s[:nkeep])
        )
        return v_new, h_new, jnp.int32(nkeep)

    v_basis, h, jstart = jax.lax.fori_loop(
        0, restarts, cycle, (v_basis, h, jnp.int32(0))
    )
    # final cycle without restart compression
    v_basis, h = jax.lax.fori_loop(jstart, m, extend, (v_basis, h))
    theta, y = rayleigh_ritz(h)
    vecs = jnp.einsum("nk,km->nm", v_basis[:, :m], y, precision=HIGHEST)
    resid = jnp.abs(h[m, m - 1] * y[m - 1, :])
    return LanczosResult(
        eigvalues=theta, eigvectors=vecs, resid=resid,
        niter=jnp.int32((restarts + 1) * m),
    )


def resolve_block_policy(restarts: int, ncv_eff: int, nondeg_dim: int,
                         blk: int | None = None):
    """Shared block-vs-scalar Lanczos dispatch policy for the LORASC builds
    (single-chip lorasc_scale.py and the distributed lorasc_driver.py must
    tune in lockstep — these constants have churned).

    Returns (blk, nblocks, restarts_eff): blk == 0 means use the scalar
    iteration. The basis dimension nblocks·blk is capped at nondeg_dim − 1
    (the B-inner product is degenerate beyond the real separator dofs — a
    basis that overruns it forces b_qr's rank-deficiency fallback and
    degrades the Ritz yield; the scalar path caps ncv the same way).
    """
    import os as _os

    if blk is None:
        blk = int(_os.environ.get("PREALPS_LANCZOS_BLOCK", "8"))
    if blk <= 1 or restarts == 0:
        return 0, 0, restarts
    nblocks = min(-(-ncv_eff // blk), max(nondeg_dim - 1, 0) // blk)
    if nblocks < 3:
        return 0, 0, restarts
    # the block iteration loses polynomial degree per cycle; ~2.4× the
    # cycles restores the scalar yield. NOT uniformly reducible: 14³ f32
    # falls off a cliff below 15 cycles (4 pairs at 14, 0 at 10), so small
    # pencils keep the conservative 2.5r+2. LARGE pencils saturate much
    # earlier — n=148k (ng=28.7k): 97 pairs at 9, 12 and 15 cycles
    # (round 4) and again 97 at 9 vs 70 at 7 (round 5) — and each cycle
    # there costs ~0.6 s of build, so cap the effective cycles at 9 when
    # the pencil is past the small-separator regime (ng > 8192, the same
    # scale gate as the exact-Schur fallback). An explicit restarts above
    # the cap is honored.
    eff = max(restarts, (restarts * 5) // 2 + 2)
    if nondeg_dim > 8192:
        eff = min(eff, max(9, restarts))
    return blk, nblocks, eff


def block_lanczos_thick_restart(
    op_apply_panel: Callable[[jax.Array], jax.Array],  # (n,bt) -> B⁻¹S panel
    b_apply_panel: Callable[[jax.Array], jax.Array],   # (n,bt) -> B panel
    n: int,
    nblocks: int,
    nev: int,
    bt: int = 8,
    restarts: int = 4,
    dtype=jnp.float64,
    v0: jax.Array | None = None,
) -> LanczosResult:
    """BLOCK thick-restart Lanczos in the B-inner product.

    Mathematically the same Wu–Simon thick-restart iteration as
    `lanczos_thick_restart`, with vectors replaced by bt-wide panels. The
    motive is the dispatch economics of the LORASC deflation build: the
    scalar iteration is ~3000 SEQUENTIAL t=1 operator applies
    (dispatch-bound — basis-size cuts don't help), while every operand (stencil SpMM, banded solves) is
    panel-capable, so bt vectors per step cost barely more than one. Block
    Lanczos also converges clustered spectra better — exactly the shape of
    the near-null deflation window. (PARPACK role: eigsolver.c:225-231.)

    Basis = nblocks panels (+1 working panel); every step B-orthonormalises
    the new panel by Cholesky-QR of its B-Gram (rank loss handled by a
    trace-scaled ridge; the downstream rayleigh_ritz_refine whitening drops
    any junk directions). Thick restart keeps a block-aligned number of
    Ritz vectors plus the residual panel.
    """
    m = nblocks
    dim = m * bt
    if m < 3:
        # nkeep_b = min(..., m-2) degenerates below 3 blocks (verified:
        # m=1/2 return unconverged or wrong pairs); callers fall back to
        # the scalar iteration for tiny bases
        raise ValueError(f"block thick-restart needs nblocks >= 3, got {m}")
    if v0 is None:
        v0 = jnp.full((n,), 1e-2, dtype=dtype)
    v0 = v0.astype(dtype)
    if v0.ndim == 1:
        # deterministic FULL-RANK start panel from the seed vector: columns
        # modulated by low-order Chebyshev-like waves (a rank-1 panel would
        # make the Cholesky-QR ridge manufacture junk near-zero directions
        # that crowd the smallest Ritz values)
        i = jnp.arange(n, dtype=dtype)
        waves = jnp.cos(
            jnp.pi * (i[:, None] + 0.5) * (jnp.arange(bt, dtype=dtype)[None]
                                           + 1.0) / n)
        v0 = v0[:, None] * (1.0 + 0.5 * waves)
    # keep ~nev + third of the slack, rounded to whole blocks, ≤ m-2 blocks
    nkeep_b = min(max((nev + (dim - nev) // 3 + bt - 1) // bt, 1), m - 2)
    kdim = nkeep_b * bt

    eps = float(jnp.finfo(dtype).eps)

    def b_qr(w):
        """B-orthonormalise a panel: w = q r with qᵀBq = I, r (bt, bt).

        Cholesky-QR loses orthogonality at κ(w)² — in f32 on high-contrast
        pencils the raw panel Gram overflows that budget immediately. Column
        B-equilibration + CholQR2 (two rounds) is the standard repair; a
        degenerate block (invariant subspace hit) zeroes out, and the
        downstream rayleigh_ritz_refine whitening drops the dead directions.
        """
        d2 = jnp.einsum("ni,ni->i", w, b_apply_panel(w), precision=HIGHEST)
        d = jnp.sqrt(jnp.maximum(d2, 1e-30))
        w = w / d[None, :]
        r_acc = jnp.diag(d.astype(dtype))

        def one(w, r_acc):
            g = jnp.einsum("ni,nj->ij", w, b_apply_panel(w),
                           precision=HIGHEST)
            g = 0.5 * (g + g.T)
            # ridge-free primary factorization (a standing ridge compounds
            # across blocks × cycles into an accuracy CEILING — measured
            # ~1e-3 pair residuals at 50·eps); ridge only as the
            # rank-deficiency fallback
            l0 = jnp.linalg.cholesky(g)
            ridge = jnp.maximum(jnp.trace(g), 1e-30) * (50.0 * eps)
            l1 = jnp.linalg.cholesky(g + ridge * jnp.eye(bt, dtype=dtype))
            l = jnp.where(jnp.any(jnp.isnan(l0)), l1, l0)
            bad = jnp.any(jnp.isnan(l))
            l = jnp.where(bad, jnp.eye(bt, dtype=dtype), l)
            q = jax.lax.linalg.triangular_solve(
                l, w, left_side=False, lower=True, transpose_a=True)
            q = jnp.where(bad, jnp.zeros_like(q), q)
            r_acc = jnp.where(bad, jnp.zeros_like(r_acc), l.T @ r_acc)
            return q, r_acc

        w, r_acc = one(w, r_acc)
        w, r_acc = one(w, r_acc)
        return w, r_acc

    v0q, _ = b_qr(v0)
    v_basis = jnp.zeros((n, (m + 1) * bt), dtype)
    v_basis = jax.lax.dynamic_update_slice(v_basis, v0q, (0, 0))
    h = jnp.zeros(((m + 1) * bt, dim), dtype)

    def extend(j, carry):
        """One block-extension step writing column-block j of h."""
        v_basis, h = carry
        zero = jnp.int32(0)
        jb = jnp.asarray(j * bt, jnp.int32)
        vj = jax.lax.dynamic_slice(v_basis, (zero, jb), (n, bt))
        w = op_apply_panel(vj)
        bw = b_apply_panel(w)
        mask = (jnp.arange((m + 1) * bt) < (j + 1) * bt).astype(dtype)
        proj = jnp.einsum("nk,ni->ki", v_basis, bw,
                          precision=HIGHEST) * mask[:, None]
        w = w - jnp.einsum("nk,ki->ni", v_basis, proj, precision=HIGHEST)
        bw2 = b_apply_panel(w)
        proj2 = jnp.einsum("nk,ni->ki", v_basis, bw2,
                           precision=HIGHEST) * mask[:, None]
        w = w - jnp.einsum("nk,ki->ni", v_basis, proj2, precision=HIGHEST)
        q, r = b_qr(w)
        v_basis = jax.lax.dynamic_update_slice(v_basis, q,
                                               (zero, jb + bt))
        hcol = jax.lax.dynamic_update_slice(
            proj + proj2, r, (jb + bt, zero))
        h = jax.lax.dynamic_update_slice(h, hcol, (zero, jb))
        return v_basis, h

    def rayleigh_ritz(h):
        hs = 0.5 * (h[:dim, :] + h[:dim, :].T)
        return jnp.linalg.eigh(hs)

    def cycle(c, carry):
        v_basis, h, jstart = carry
        v_basis, h = jax.lax.fori_loop(jstart, m, extend, (v_basis, h))
        theta, y = rayleigh_ritz(h)
        # residual couplings: R_m · y[last block rows] (bt × dim)
        s = jnp.einsum("ij,jk->ik", h[dim:, dim - bt:], y[dim - bt:, :],
                       precision=HIGHEST)
        v_keep = jnp.einsum("nk,km->nm", v_basis[:, :dim], y[:, :kdim],
                            precision=HIGHEST)
        v_res = v_basis[:, dim:]
        v_new = jnp.zeros_like(v_basis)
        v_new = jax.lax.dynamic_update_slice(v_new, v_keep, (0, 0))
        v_new = jax.lax.dynamic_update_slice(v_new, v_res, (0, kdim))
        h_new = (
            jnp.zeros_like(h)
            .at[jnp.arange(kdim), jnp.arange(kdim)].set(theta[:kdim])
        )
        h_new = jax.lax.dynamic_update_slice(h_new, s[:, :kdim], (kdim, 0))
        return v_new, h_new, jnp.int32(nkeep_b)

    v_basis, h, jstart = jax.lax.fori_loop(
        0, restarts, cycle, (v_basis, h, jnp.int32(0))
    )
    v_basis, h = jax.lax.fori_loop(jstart, m, extend, (v_basis, h))
    theta, y = rayleigh_ritz(h)
    vecs = jnp.einsum("nk,km->nm", v_basis[:, :dim], y, precision=HIGHEST)
    s = jnp.einsum("ij,jk->ik", h[dim:, dim - bt:], y[dim - bt:, :],
                   precision=HIGHEST)
    resid = jnp.sqrt(jnp.einsum("ik,ik->k", s, s, precision=HIGHEST))
    return LanczosResult(
        eigvalues=theta, eigvectors=vecs, resid=resid,
        niter=jnp.int32((restarts + 1) * m * bt),
    )


def rayleigh_ritz_refine(vecs, sv, bv, drop_tol: float = 1e-3):
    """Subspace Rayleigh-Ritz refinement of candidate Ritz pairs for the
    pencil (S, B), given the candidate panel and its S·V / B·V products.

    Projects onto span(vecs), whitens B (dropping near-dependent directions
    — thick-restart duplicates have ~zero whitened mass and a duplicate
    passes any residual filter), and re-solves the small generalized
    problem. Returns (theta, vecs_r, bnorm2, resid) with theta ascending,
    vecs_r B-orthonormal, and resid = TRUE residual ‖S u − θ B u‖₂ per pair.
    Dropped directions surface with a huge theta (never selected).
    """
    hp = jnp.einsum("gi,gj->ij", vecs, sv, precision=HIGHEST)
    bp = jnp.einsum("gi,gj->ij", vecs, bv, precision=HIGHEST)
    hp = 0.5 * (hp + hp.T)
    bp = 0.5 * (bp + bp.T)
    # column B-equilibration: candidates of wildly different B-norms (e.g.
    # residual-augmented panels, where OP·v scales as 1/θ) would otherwise
    # put a ~1/θ² dynamic range into bp and the f32 whitening eigh drowns
    # the small directions (eps·range ≫ 1)
    d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diag(bp)), 1e-30))
    hp = hp / d[:, None] / d[None, :]
    bp = bp / d[:, None] / d[None, :]
    dmu, u = jnp.linalg.eigh(bp)
    keep = dmu > drop_tol
    dsafe = jnp.where(keep, dmu, 1.0)
    w = u * jnp.where(keep, 1.0 / jnp.sqrt(dsafe), 0.0)[None, :]
    sw = w.T @ hp @ w
    sw = 0.5 * (sw + sw.T)
    big = jnp.asarray(1e6, sw.dtype)
    sw = sw + jnp.diag(jnp.where(keep, 0.0, big))
    theta, z = jnp.linalg.eigh(sw)
    wz = (w @ z) / d[:, None]   # fold the equilibration back in
    vecs_r = jnp.einsum("gk,km->gm", vecs, wz, precision=HIGHEST)
    svr = jnp.einsum("gk,km->gm", sv, wz, precision=HIGHEST)
    bvr = jnp.einsum("gk,km->gm", bv, wz, precision=HIGHEST)
    bnorm2 = jnp.einsum("gk,gk->k", vecs_r, bvr, precision=HIGHEST)
    r_true = svr - theta[None, :] * bvr
    resid = jnp.sqrt(
        jnp.einsum("gk,gk->k", r_true, r_true, precision=HIGHEST)
    )
    return theta, vecs_r, bnorm2, resid
