"""Enlarged Conjugate Gradient (ECG) — functional JAX implementation.

Solves SPD systems A x = b with t "enlarged" search directions per iteration
(the communication-avoiding family of Grigori/Moufawad/Tissot implemented by
the reference in src/solvers/ecg.c). Three variants, as in the reference
(reference: src/solvers/ecg.h:23-27 ORTHOMIN/ORTHODIR/ORTHODIR_FUSED):

* omin  — orthomin: new directions from the preconditioned residual.
* odir  — orthodir: new directions from M⁻¹AP, A-orthogonalised against the
          last two direction blocks.
* odir_fused — orthodir reorganised so ALL cross-device reductions of one
          iteration (P'R, (AV)'Z, (AP)'P, R'R — 5t² numbers) ride a single
          psum (reference: ecg.c:556-565 single MPI_Allreduce). This is the
          default: one fused collective per iteration is the
          latency-optimal shape.

Design differences vs the reference (a redesign, not a port):
* No reverse-communication state machine: the caller passes jittable
  operator callbacks `a_apply` / `m_apply`, preserving the matrix-free
  property; the entire solve is ONE `lax.while_loop` under jit.
* Dynamic search-direction reduction (ADAPT_BS, reference ecg.c:444-497)
  keeps static shapes: directions are deactivated by a prefix mask after a
  rotation by the left singular vectors of alpha, instead of shrinking
  arrays. Dropped direction columns stay in P as a frozen A-orthonormal
  basis for later orthogonalisation (the analog of the reference's stale-V
  bookkeeping, ecg.c:494-496).
* Works identically single-device (axis_name=None) and inside shard_map
  (axis_name="shards"): all reductions go through `psum`.
* Panels support two memory layouts (solvers/panels.py): rows-major "nt"
  and lane-major "tbn" — the latter keeps the long node axis minor, which
  is the fast path on the GPU.

All heavy products are tall-skinny GEMMs with t as the batch dimension.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from prealps_tpu.ops.blockops import (
    HIGHEST,
    chol_masked,
    pivoted_cholesky,
    psum,
    tri_inv,
)
from prealps_tpu.solvers.panels import LAYOUTS, NT


@dataclass(frozen=True)
class ECGOptions:
    t: int = 8                   # enlarging factor (number of rhs splits)
    tol: float = 1e-5            # relative residual tolerance ||R||_F/||b||
    maxiter: int = 10000
    variant: str = "odir_fused"  # omin | odir | odir_fused
    adaptive: bool = False       # dynamic search-direction reduction
    adaptive_mode: str = "truncate"  # truncate = the reference's ADAPT_BS
                                 # semantics (drop reduced directions,
                                 # ecg.c:485-496; exact -r 1 parity, and
                                 # exactly as fragile: the SVD test can
                                 # mis-trigger and stall — see
                                 # tests/test_parity.py). freeze = keep the
                                 # dropped columns as a frozen basis; loses
                                 # strict parity but converges where the
                                 # reference heuristic stalls (measured:
                                 # elasticity t=8 to 1e-8 vs a 2e-4 stall).
    record_history: bool = True
    layout: str = "nt"           # nt | tbn (lane-major, GPU fast path)
    stall_window: int = 0        # >0: stop after this many CONSECUTIVE
                                 # iterations whose residual improved by less
                                 # than stall_rtol (relative). Default off —
                                 # CG residuals plateau transiently, so this
                                 # is only safe where an early stop is
                                 # recoverable (mixed-precision refinement
                                 # inner solves set it to 250: long enough to
                                 # ride out block-CG plateaus, short enough
                                 # not to burn maxiter at the f32 floor —
                                 # the reference simply burns maxiter).
                                 # Within 2x of tol a plateau ends after a
                                 # tenth of the window (_NEAR_TOL).
    stall_rtol: float = 5e-4     # per-iteration relative improvement that
                                 # counts as progress. 5e-4 ≈ the f32 floor's
                                 # noise band: a true floor jitters well
                                 # below it, while even slow (0.999/iter)
                                 # geometric convergence clears it.
    stacked: Optional[bool] = None  # None = auto: stack the 7 solver panels
                                 # into ONE array so each iteration is one
                                 # Gram matmul + one panel GEMM (see
                                 # _iter_odir_fused_stacked).
                                 # Auto-enabled for layout="tbn" +
                                 # variant="odir_fused"; handles adaptive
                                 # too (the SVD rotation composes into the
                                 # coefficient GEMM).

    def __post_init__(self):
        if self.t < 1:
            raise ValueError(f"enlarging factor t must be >= 1, got {self.t}")
        if self.maxiter < 1:
            raise ValueError(f"maxiter must be >= 1, got {self.maxiter}")
        if not (self.tol > 0):
            raise ValueError(f"tol must be positive, got {self.tol}")
        if self.variant not in ("omin", "odir", "odir_fused"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.layout not in ("nt", "tbn"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.adaptive_mode not in ("truncate", "freeze"):
            raise ValueError(
                f"unknown adaptive_mode {self.adaptive_mode!r}")
        if self.stacked and self.variant == "odir":
            raise ValueError(
                "stacked fast paths exist for omin and odir_fused only")
        if self.stacked and self.layout != "tbn":
            # nt panels are (m, t): the stacked reshape would treat node
            # rows as direction slots and silently compute garbage
            raise ValueError("stacked=True requires layout='tbn'")


class ECGResult(NamedTuple):
    x: jax.Array            # local solution rows; shape = panel space shape
    iters: jax.Array        # iteration count
    res: jax.Array          # final ||R||_F
    normb: jax.Array
    bs: jax.Array           # final active block size
    breakdown: jax.Array    # True if P'AP lost positive definiteness
    history: jax.Array      # ||R||_F per iteration (maxiter,), padded with -1


class _State(NamedTuple):
    x_blk: jax.Array
    r: jax.Array
    p: jax.Array
    ap: jax.Array
    p_prev: jax.Array
    ap_prev: jax.Array
    z: jax.Array
    mask: jax.Array     # (t,) active-direction mask (1.0 prefix)
    it: jax.Array
    res: jax.Array
    breakdown: jax.Array
    history: jax.Array
    best_res: jax.Array  # smallest residual seen (stagnation tracking)
    stall: jax.Array     # iterations since meaningful improvement


# A plateau within this factor of the tolerance is the f32 floor, not a
# transient block-CG plateau, and each of its iterations counts this many
# times towards stall_window (250 -> 25 iterations). odir_fused's recursive
# residual flattens at its floor where omin's keeps falling: with an almost
# exact preconditioner (exact-Schur LORASC on elasticity3d(8³), κ≈3e5) the
# floor lies at 0.7-1.1× a 1e-3 inner tolerance, and a full window there
# costs 250 idle iterations per refinement round.
_NEAR_TOL = 2.0
_NEAR_TOL_WEIGHT = 10


def _track_stall(state: "_State", res, opts: "ECGOptions", normb):
    # an improvement below stall_rtol does not count as progress: a terminal
    # f32 floor jitters below it while real convergence (even slow geometric
    # rates) clears it every iteration (see ECGOptions.stall_rtol)
    improved = res < (1.0 - opts.stall_rtol) * state.best_res
    best = jnp.minimum(state.best_res, res)
    near = best <= _NEAR_TOL * opts.tol * normb
    step = jnp.where(near, jnp.int32(_NEAR_TOL_WEIGHT), jnp.int32(1))
    stall = jnp.where(improved, jnp.int32(0), state.stall + step)
    return best, stall


def split_rhs(b: jax.Array, t: int, assign=None, ops=NT) -> jax.Array:
    """Split rhs b into t disjoint row groups (reference: ecg.c:201
    _preAlps_ECGSplit puts rank r's rows into column r % t). Default:
    contiguous equal split of the flattened local rows."""
    if assign is None:
        m = int(np.prod(b.shape)) if b.ndim > 1 else b.shape[0]
        flat_assign = (jnp.arange(m) * t) // m
        assign = flat_assign.reshape(b.shape).astype(jnp.int32)
    return ops.split(b, t, assign)


def _gram(ops, x, y, axis_name):
    return psum(ops.gram(x, y), axis_name)


def _rotate_reduce(ops, alpha, p, ap, z, mask, red_tol, dtype):
    """Adaptive search-direction reduction (reference: ecg.c:444-497).

    SVD of alpha = U Σ Vᵀ; directions rotated by U, those with σ ≤ red_tol
    deactivated. Dropped P/AP columns are kept (frozen basis)."""
    t = alpha.shape[0]
    alpha_m = alpha * mask[:, None]
    u_svd, sig, _ = jnp.linalg.svd(alpha_m.astype(dtype))
    t1 = jnp.sum((sig > red_tol).astype(jnp.int32))
    bs = jnp.sum(mask).astype(jnp.int32)
    do_red = (t1 > 0) & (t1 < bs)
    new_bs = jnp.where(do_red, t1, bs)
    new_mask = (jnp.arange(t) < new_bs).astype(alpha.dtype)

    def apply_rot(args):
        alpha, p, ap, z = args
        a2 = jnp.einsum("ij,ik->jk", u_svd, alpha, precision=HIGHEST)
        return a2, ops.rotate(p, u_svd), ops.rotate(ap, u_svd), ops.rotate(z, u_svd)

    alpha, p, ap, z = jax.lax.cond(
        do_red, apply_rot, lambda args: args, (alpha, p, ap, z)
    )
    alpha = alpha * new_mask[:, None]
    return alpha, p, ap, ops.scale_dirs(z, new_mask), new_mask


def _iter_omin(state: _State, a_apply, m_apply, axis_name, opts, normb, red_tol, ops):
    p, ap, r, x_blk, mask = state.p, state.ap, state.r, state.x_blk, state.mask
    dtype = state.res.dtype
    # --- A-CholQR of P against AP (reference: ecg.c:307-328) ---
    c = _gram(ops, ap, p, axis_name)
    u = chol_masked(c, mask)
    breakdown = jnp.any(jnp.isnan(u))
    u = jnp.where(breakdown, jnp.eye(u.shape[0], dtype=dtype), u)
    u_inv = tri_inv(u)   # one t×t inversion; panel trisolves become matmuls
    p = ops.mix(p, u_inv)
    ap = ops.mix(ap, u_inv)
    # --- alpha and update (ecg.c:330-339) ---
    alpha = _gram(ops, p, r, axis_name)
    x_blk = ops.update(x_blk, p, alpha)
    r = ops.downdate(r, ap, alpha)
    # --- stopping quantity (ecg.c:223 StoppingCriterion) ---
    rtr = _gram(ops, r, r, axis_name)
    res = jnp.sqrt(jnp.trace(rtr))
    # --- new direction: Z = M⁻¹R, A-orthogonalise against P (ecg.c:345-358) ---
    z = m_apply(r)
    beta = _gram(ops, ap, z, axis_name)
    p_new = ops.downdate(z, p, beta)
    if opts.adaptive:
        # BF-Omin: rank-revealing pivoted Cholesky of PᵀP (ecg.c:361-393)
        c2 = _gram(ops, p_new, p_new, axis_name)
        u2, piv, rank = pivoted_cholesky(c2, jnp.asarray(-1.0, dtype))
        bs = jnp.sum(mask).astype(jnp.int32)
        t1 = jnp.minimum(rank, bs)
        new_mask = (jnp.arange(mask.shape[0]) < t1).astype(dtype)
        diag_fix = (jnp.abs(jnp.diag(u2)) == 0).astype(dtype)
        u2 = u2 + jnp.diag(diag_fix)
        p_perm = ops.take_dirs(p_new, piv)
        p_new = ops.scale_dirs(ops.right_solve(u2, p_perm), new_mask)
        mask = new_mask
    p_new = ops.scale_dirs(p_new, mask)
    ap_new = a_apply(p_new)
    best_res, stall = _track_stall(state, res, opts, normb)
    return state._replace(
        x_blk=x_blk, r=r, p=p_new, ap=ap_new, z=z, mask=mask,
        it=state.it + 1, res=res,
        breakdown=state.breakdown | breakdown,
        history=state.history.at[state.it].set(res) if opts.record_history else state.history,
        best_res=best_res, stall=stall,
    )


def _iter_odir(state: _State, a_apply, m_apply, axis_name, opts, normb, red_tol, ops):
    p, ap, r, x_blk, mask = state.p, state.ap, state.r, state.x_blk, state.mask
    p_prev, ap_prev = state.p_prev, state.ap_prev
    dtype = state.res.dtype
    # --- A-CholQR (ecg.c:421-436) ---
    c = _gram(ops, ap, p, axis_name)
    u = chol_masked(c, mask)
    breakdown = jnp.any(jnp.isnan(u))
    u = jnp.where(breakdown, jnp.eye(u.shape[0], dtype=dtype), u)
    u_inv = tri_inv(u)
    p = ops.mix(p, u_inv)
    ap = ops.mix(ap, u_inv)
    # --- alpha (ecg.c:437-443) ---
    alpha = _gram(ops, p, r, axis_name)
    if opts.adaptive:
        alpha, p, ap, _z, mask = _rotate_reduce(
            ops, alpha, p, ap, jnp.zeros_like(p), mask, red_tol, dtype
        )
        if opts.adaptive_mode == "truncate":
            # TRUNCATE the dropped directions like the reference
            # (ecg.c:485-496 shrinks P/AP to t1 columns) — round 3 always
            # kept them as a frozen basis, which measurably diverges
            # (LFAT5 -r: frozen stalls at maxiter vs the oracle's 6
            # iterations; truncated matches exactly)
            p = ops.scale_dirs(p, mask)
            ap = ops.scale_dirs(ap, mask)
    # --- update (ecg.c:500-501) ---
    x_blk = ops.update(x_blk, p, alpha)
    r = ops.downdate(r, ap, alpha)
    rtr = _gram(ops, r, r, axis_name)
    res = jnp.sqrt(jnp.trace(rtr))
    # --- new direction: Z = M⁻¹AP, A-orthogonalise against V=[P, P_prev]
    #     (ecg.c:508-527) ---
    z = m_apply(ap)
    beta1 = _gram(ops, ap, z, axis_name)
    beta2 = _gram(ops, ap_prev, z, axis_name)
    z = ops.downdate(z, p, beta1)
    z = ops.downdate(z, p_prev, beta2)
    z = ops.scale_dirs(z, mask)
    p_new = z
    if opts.adaptive and opts.adaptive_mode == "freeze":
        p_new = z + ops.scale_dirs(p, 1.0 - mask)   # frozen columns kept
    ap_new = a_apply(p_new)
    best_res, stall = _track_stall(state, res, opts, normb)
    return state._replace(
        x_blk=x_blk, r=r, p=p_new, ap=ap_new,
        p_prev=ops.scale_dirs(p, mask), ap_prev=ops.scale_dirs(ap, mask),
        z=z, mask=mask,
        it=state.it + 1, res=res,
        breakdown=state.breakdown | breakdown,
        history=state.history.at[state.it].set(res) if opts.record_history else state.history,
        best_res=best_res, stall=stall,
    )


def _iter_odir_fused(state: _State, a_apply, m_apply, axis_name, opts, normb, red_tol, ops):
    """One iteration with a SINGLE fused reduction (reference: ecg.c:532-658).

    Entering state: P, AP=A·P (pre-orthonormalisation), Z = M⁻¹AP,
    V = [P, P_prev], AV = [AP, AP_prev]. The Gram blocks are computed on the
    raw P/AP and corrected through the triangular factor afterwards:
      alphã = U⁻ᵀ (PᵀR),   betã = [U⁻ᵀ (APᵀZ) U⁻¹ ; (AP_prev)ᵀ Z U⁻¹].
    """
    p, ap, r, x_blk, mask = state.p, state.ap, state.r, state.x_blk, state.mask
    p_prev, ap_prev, z = state.p_prev, state.ap_prev, state.z
    dtype = state.res.dtype
    t = mask.shape[0]

    # --- single fused reduction of 5 t² blocks (ecg.c:556-565) ---
    fused_local = jnp.stack([
        ops.gram(p, r),
        ops.gram(ap, z),
        ops.gram(ap_prev, z),
        ops.gram(ap, p),
        ops.gram(r, r),
    ])
    fused = psum(fused_local, axis_name)
    alpha, beta1, beta2, mu, rtr = (fused[i] for i in range(5))

    res = jnp.sqrt(jnp.trace(rtr))

    # --- orthonormalisation through the factor (ecg.c:577-588) ---
    u = chol_masked(mu, mask)
    breakdown = jnp.any(jnp.isnan(u))
    u = jnp.where(breakdown, jnp.eye(t, dtype=dtype), u)
    u_inv = tri_inv(u)   # one t×t inversion; all factor applications below
    p = ops.mix(p, u_inv)
    ap = ops.mix(ap, u_inv)
    z = ops.mix(z, u_inv)
    alpha = jnp.einsum("dr,dk->rk", u_inv, alpha, precision=HIGHEST) * mask[:, None]
    beta1 = jnp.einsum("dr,dk,ks->rs", u_inv, beta1, u_inv, precision=HIGHEST)
    beta2 = jnp.einsum("dk,ks->ds", beta2, u_inv, precision=HIGHEST)

    # --- Z -= V beta (ecg.c:590-591) ---
    z = ops.downdate(z, p, beta1)
    z = ops.downdate(z, p_prev, beta2)

    if opts.adaptive:
        alpha, p, ap, z, mask = _rotate_reduce(
            ops, alpha, p, ap, z, mask, red_tol, dtype
        )

    # --- X, R update (ecg.c:644-645) ---
    x_blk = ops.update(x_blk, p, alpha)
    r = ops.downdate(r, ap, alpha)

    # --- roll V; dropped directions are TRUNCATED like the reference
    #     (ecg.c:485-496 — the round-3 frozen-basis form diverged from the
    #     oracle under -r, see _iter_odir) unless adaptive_mode="freeze" ---
    z = ops.scale_dirs(z, mask)
    p_new = z
    if opts.adaptive and opts.adaptive_mode == "freeze":
        p_new = z + ops.scale_dirs(p, 1.0 - mask)
    ap_new = a_apply(p_new)
    z_new = m_apply(ap_new)
    best_res, stall = _track_stall(state, res, opts, normb)
    return state._replace(
        x_blk=x_blk, r=r, p=p_new, ap=ap_new,
        p_prev=ops.scale_dirs(p, mask), ap_prev=ops.scale_dirs(ap, mask),
        z=z_new, mask=mask, it=state.it + 1, res=res,
        breakdown=state.breakdown | breakdown,
        history=state.history.at[state.it].set(res) if opts.record_history else state.history,
        best_res=best_res, stall=stall,
    )


# ---------------------------------------------------------------------------
# Stacked odir_fused: the whole iteration as TWO large matmuls
# ---------------------------------------------------------------------------
#
# Every panel operation of an odir_fused iteration (mix by U⁻¹, the four
# downdates/updates, the mask scalings, the V-roll) is a right-multiplication
# of some panel by a small t×t matrix, and every reduction is a t×t block of
# the Gram matrix of the panel set. Storing the seven panels
# [X, R, P, P_prev, AP, AP_prev, Z] as ONE (7, t, *space) array turns the
# iteration into
#     G  = psum(W Wᵀ)              (one (7t)² Gram — the reference's fused
#                                    single allreduce, ecg.c:556-565, with
#                                    the panel reads fused too)
#     W' = C W                     (one (7t)×(7t) composed coefficient GEMM)
#     AP', Z' slots <- A·P', M⁻¹AP' (SpMM + preconditioner)
# i.e. ~4 passes over the panel set in device memory instead of ~37
# separate op passes.
# Mathematically identical to _iter_odir_fused (same order of corrections
# through the Cholesky factor); not bit-identical (different GEMM grouping).

_SX, _SR, _SP, _SPP, _SAP, _SAPP, _SZ = range(7)

# stacked omin slot layout (5 panels; X is slot 0 in BOTH layouts, which is
# what ecg_finalize relies on)
_OX, _OR, _OP, _OAP, _OZ = range(5)


def _use_stacked(opts: "ECGOptions") -> bool:
    if opts.stacked is not None:
        return opts.stacked
    # omin stays unstacked by default: its sequential M-dependency leaves
    # three separate reductions either way — opt in with stacked=True
    return opts.layout == "tbn" and opts.variant == "odir_fused"


def _is_stacked_state(state: "_State") -> bool:
    # stacked states carry W in x_blk and zero-size placeholders elsewhere
    return state.r.ndim == 1 and state.r.shape[0] == 0


def _iter_odir_fused_stacked(state, a_apply, m_apply, axis_name, opts,
                             normb, red_tol, ops):
    W2 = state.x_blk                    # (7t, prod(space)) FLAT 2-D: the
    # Gram and the C-GEMM are plain 2-D matmuls; panels are reshaped only
    # at the operator boundary
    panel_shape = state.p.shape[1:]     # (t, *space) carried by placeholder
    mask = state.mask
    dtype = state.res.dtype
    t = mask.shape[0]

    # --- ONE Gram + ONE psum: all five t×t blocks at once ---
    G = psum(jnp.einsum("aX,bX->ab", W2, W2, precision=HIGHEST), axis_name)
    Gb = G.reshape(7, t, 7, t)
    alpha_raw = Gb[_SP, :, _SR, :]      # PᵀR
    beta1_raw = Gb[_SAP, :, _SZ, :]     # APᵀZ
    beta2_raw = Gb[_SAPP, :, _SZ, :]    # AP_prevᵀZ
    mu = Gb[_SAP, :, _SP, :]            # APᵀP
    rtr = Gb[_SR, :, _SR, :]
    res = jnp.sqrt(jnp.trace(rtr))

    # --- factor + corrections (identical algebra to _iter_odir_fused) ---
    u = chol_masked(mu, mask)
    breakdown = jnp.any(jnp.isnan(u))
    u = jnp.where(breakdown, jnp.eye(t, dtype=dtype), u)
    ui = tri_inv(u)
    alpha = jnp.einsum("dr,dk->rk", ui, alpha_raw,
                       precision=HIGHEST) * mask[:, None]
    beta1 = jnp.einsum("dr,dk,ks->rs", ui, beta1_raw, ui, precision=HIGHEST)
    beta2 = jnp.einsum("dk,ks->ds", beta2_raw, ui, precision=HIGHEST)

    # --- adaptive reduction (reference ecg.c:444-497): the SVD rotation R of
    #     the direction block is ALSO a right-multiplication — it composes
    #     into C instead of touching the panels. Rotated quantities:
    #     P̃ = P·Ui·R, Ẑ·R = Z·(Ui R) − P·(Ui β₁ R) − P_prev·(β₂ R),
    #     α̃ = Rᵀ α (rows re-masked) ---
    eye = jnp.eye(t, dtype=dtype)
    uiB1 = jnp.einsum("dr,rk->dk", ui, beta1, precision=HIGHEST)   # Ui·beta1
    if opts.adaptive:
        u_svd, sig, _ = jnp.linalg.svd(alpha)
        t1 = jnp.sum((sig > red_tol).astype(jnp.int32))
        bs = jnp.sum(mask).astype(jnp.int32)
        do_red = (t1 > 0) & (t1 < bs)
        new_bs = jnp.where(do_red, t1, bs)
        mask = (jnp.arange(t) < new_bs).astype(dtype)
        rot = jnp.where(do_red, u_svd, eye)
        alpha = jnp.einsum("ij,ik->jk", rot, alpha,
                           precision=HIGHEST) * mask[:, None]
        ui = jnp.einsum("dr,rk->dk", ui, rot, precision=HIGHEST)
        uiB1 = jnp.einsum("dr,rk->dk", uiB1, rot, precision=HIGHEST)
        beta2 = jnp.einsum("dk,ks->ds", beta2, rot, precision=HIGHEST)

    # --- compose the iteration's panel algebra into C: W'_a = Σ_b W_b C[b,a]
    #     (C[b, d, a, r] = weight of old slot b, direction d in new slot a,
    #      direction r — right-multiplication convention of TBN.mix) ---
    uiA = jnp.einsum("dr,rk->dk", ui, alpha, precision=HIGHEST)    # Ui·alpha
    act = mask[None, :]                 # scales NEW direction columns
    frz = 1.0 - mask[None, :]
    C = jnp.zeros((7, t, 7, t), dtype)
    C = C.at[_SX, :, _SX, :].set(eye)                    # X' = X + P̂ alpha
    C = C.at[_SP, :, _SX, :].set(uiA)
    C = C.at[_SR, :, _SR, :].set(eye)                    # R' = R − AP̂ alpha
    C = C.at[_SAP, :, _SR, :].set(-uiA)
    # P' = (Z Ui − P Ui beta1 − P_prev beta2)·diag(mask); dropped directions
    # are truncated to zero like the reference (ecg.c:485-496), or kept as a
    # frozen basis under adaptive_mode="freeze"
    C = C.at[_SZ, :, _SP, :].set(ui * act)
    keep_frozen = (ui * frz if opts.adaptive
                   and opts.adaptive_mode == "freeze" else 0.0)
    C = C.at[_SP, :, _SP, :].set(-uiB1 * act + keep_frozen)
    C = C.at[_SPP, :, _SP, :].set(-beta2 * act)
    C = C.at[_SP, :, _SPP, :].set(ui * act)              # P_prev' = P̂·mask
    C = C.at[_SAP, :, _SAPP, :].set(ui * act)            # AP_prev' = AP̂·mask
    Wn = jnp.einsum("dk,dX->kX", C.reshape(7 * t, 7 * t), W2,
                    precision=HIGHEST)

    # --- operator + preconditioner fill the AP / Z slots ---
    p_new = Wn[_SP * t:(_SP + 1) * t].reshape(panel_shape)
    ap_new = a_apply(p_new)
    z_new = m_apply(ap_new)
    Wn = (
        Wn.at[_SAP * t:(_SAP + 1) * t].set(ap_new.reshape(t, -1))
           .at[_SZ * t:(_SZ + 1) * t].set(z_new.reshape(t, -1))
    )

    best_res, stall = _track_stall(state, res, opts, normb)
    return state._replace(
        x_blk=Wn, mask=mask, it=state.it + 1, res=res,
        breakdown=state.breakdown | breakdown,
        history=state.history.at[state.it].set(res) if opts.record_history else state.history,
        best_res=best_res, stall=stall,
    )


def _iter_omin_stacked(state, a_apply, m_apply, axis_name, opts,
                       normb, red_tol, ops):
    """Stacked orthomin: panels [X, R, P, AP, Z] as ONE flat (5t, N) array.

    What stacking buys for omin is the flat storage: every panel op is one
    2-D matmul over the stacked array. The reduction structure is
    deliberately NOT fused beyond the reference's own omin (ecg.c:289-400,
    three allreduces): computing alpha as Uiᵀ(PᵀR) off one big Gram — the
    odir_fused trick — amplifies the raw Gram's f32 rounding by κ(U), and on
    high-contrast problems that loses the true-residual tracking that makes
    omin the f32-robust variant (measured: het 14³, honest 2.6e-3 vs a 9e-2
    true residual with the fused form). So: normalize FIRST, then alpha on
    the normalized panel — operation order identical to _iter_omin, storage
    flat.
    """
    W2 = state.x_blk                       # (5t, N) flat
    panel_shape = state.p.shape[1:]
    mask = state.mask
    dtype = state.res.dtype
    t = mask.shape[0]

    # --- reduction 1: mu = APᵀP and the entering residual's rtr ---
    B = W2[_OR * t:(_OAP + 1) * t]         # contiguous [R, P, AP] rows
    G = psum(jnp.einsum("aX,bX->ab", B, B, precision=HIGHEST), axis_name)
    Gb = G.reshape(3, t, 3, t)
    rtr = Gb[0, :, 0, :]
    mu = Gb[2, :, 1, :]                    # APᵀP
    res = jnp.sqrt(jnp.trace(rtr))

    # --- A-CholQR: materialize P̂ = P·Ui, AP̂ = AP·Ui (ecg.c:307-328) ---
    u = chol_masked(mu, mask)
    breakdown = jnp.any(jnp.isnan(u))
    u = jnp.where(breakdown, jnp.eye(t, dtype=dtype), u)
    ui = tri_inv(u)
    pap = W2[_OP * t:(_OAP + 1) * t].reshape(2, t, -1)
    pap = jnp.einsum("dr,sdX->srX", ui, pap, precision=HIGHEST)
    p_hat, ap_hat = pap[0], pap[1]

    # --- reduction 2: alpha on the NORMALIZED panel (ecg.c:330-339) ---
    r_rows = W2[_OR * t:(_OR + 1) * t]
    alpha = psum(jnp.einsum("dX,kX->dk", p_hat, r_rows, precision=HIGHEST),
                 axis_name) * mask[:, None]
    x_rows = W2[_OX * t:(_OX + 1) * t] + jnp.einsum(
        "dr,dX->rX", alpha, p_hat, precision=HIGHEST)
    r_rows = r_rows - jnp.einsum(
        "dr,dX->rX", alpha, ap_hat, precision=HIGHEST)

    # --- Z = M⁻¹ R' (the sequential step omin is defined by) ---
    z = m_apply(r_rows.reshape(panel_shape))
    zf = z.reshape(t, -1)

    # --- reduction 3: beta = AP̂ᵀZ; new direction P ← (Z − P̂β)·mask ---
    beta = psum(jnp.einsum("dX,kX->dk", ap_hat, zf, precision=HIGHEST),
                axis_name)
    p_new = (zf - jnp.einsum("dr,dX->rX", beta, p_hat, precision=HIGHEST))
    if opts.adaptive:
        # BF-Omin rank test (ecg.c:361-393): pivoted Cholesky of P″ᵀP″;
        # the permutation and trisolve are right-multiplications, so they
        # compose into ONE small matrix applied to p_new
        c2 = psum(jnp.einsum("dX,kX->dk", p_new, p_new, precision=HIGHEST),
                  axis_name)
        u2, piv, rank = pivoted_cholesky(c2, jnp.asarray(-1.0, dtype))
        bs = jnp.sum(mask).astype(jnp.int32)
        t1 = jnp.minimum(rank, bs)
        mask = (jnp.arange(t) < t1).astype(dtype)
        diag_fix = (jnp.abs(jnp.diag(u2)) == 0).astype(dtype)
        u2 = u2 + jnp.diag(diag_fix)
        perm = jax.nn.one_hot(piv, t, dtype=dtype)       # perm[r,d]=1 ⇔ piv[r]=d
        u2inv = tri_inv(u2)
        # target rows = U₂⁻ᵀ (perm @ p_new); the einsum applies mix2ᵀ, so
        # mix2 = (U₂⁻ᵀ perm)ᵀ = permᵀ U₂⁻¹
        mix2 = jnp.einsum("dr,dk->rk", perm, u2inv, precision=HIGHEST)
        p_new = jnp.einsum("dr,dX->rX", mix2, p_new, precision=HIGHEST)
    p_new = p_new * mask[:, None]
    ap_new = a_apply(p_new.reshape(panel_shape)).reshape(t, -1)
    Wn = jnp.concatenate([x_rows, r_rows, p_new, ap_new, zf])

    best_res, stall = _track_stall(state, res, opts, normb)
    return state._replace(
        x_blk=Wn, mask=mask, it=state.it + 1, res=res,
        breakdown=state.breakdown | breakdown,
        history=state.history.at[state.it].set(res) if opts.record_history else state.history,
        best_res=best_res, stall=stall,
    )


_ITER_FNS = {
    "omin": _iter_omin,
    "odir": _iter_odir,
    "odir_fused": _iter_odir_fused,
}


def ecg_init(
    a_apply, m_apply, b: jax.Array, opts: ECGOptions,
    axis_name=None, split_assign=None,
):
    """Initial solver state + normb (the ECGInitialize/Reset analog,
    reference: ecg.c:98-199). State is a plain pytree — snapshot/restore it
    freely (checkpoint/resume, see solvers/checkpoint.py)."""
    ops = LAYOUTS[opts.layout]
    t = opts.t
    dtype = b.dtype
    normb = jnp.sqrt(psum(jnp.vdot(b, b), axis_name))
    r0 = split_rhs(b, t, split_assign, ops)
    # Exactly-zero split columns (rhs supported on a subset of the domain)
    # would make the first A-CholQR singular; the reference aborts there
    # ("P^tAP is not spd!", ecg.c:320). Instead: permute zero columns behind
    # the active prefix and start with a reduced mask — the column sum in
    # ecg_finalize is permutation-invariant, so the solution is unchanged.
    col2 = jnp.diag(psum(ops.gram(r0, r0), axis_name))
    nz = col2 > 0
    order = jnp.argsort(jnp.where(nz, 0, 1), stable=True)
    r0 = ops.take_dirs(r0, order)
    mask0 = (jnp.arange(t) < jnp.sum(nz)).astype(dtype)
    p0 = m_apply(r0)
    ap0 = a_apply(p0)
    z0 = m_apply(ap0) if opts.variant == "odir_fused" else jnp.zeros_like(p0)
    zeros = jnp.zeros_like(p0)
    history = jnp.full((opts.maxiter,), -1.0, dtype)
    if _use_stacked(opts):
        # panels in ONE FLAT 2-D array (see _iter_odir_fused_stacked): 7 slots for odir_fused, 5 for omin
        # (slot layouts _SX…/_OX… — X is slot 0 in both); the zero-size `p`
        # placeholder carries the panel shape for the operator boundary
        if opts.variant == "omin":
            w0 = jnp.stack([zeros, r0, p0, ap0, zeros])
        else:
            w0 = jnp.stack([zeros, r0, p0, zeros, ap0, zeros, z0])
        w0 = w0.reshape(-1, int(np.prod(p0.shape[1:])))
        empty = jnp.zeros((0,), dtype)
        state0 = _State(
            x_blk=w0, r=empty, p=jnp.zeros((0,) + p0.shape, dtype), ap=empty,
            p_prev=empty, ap_prev=empty, z=empty,
            mask=mask0, it=jnp.int32(0),
            res=normb.astype(dtype), breakdown=jnp.bool_(False),
            history=history,
            best_res=normb.astype(dtype), stall=jnp.int32(0),
        )
        return state0, normb
    state0 = _State(
        x_blk=zeros, r=r0, p=p0, ap=ap0, p_prev=zeros, ap_prev=zeros, z=z0,
        mask=mask0, it=jnp.int32(0),
        res=normb.astype(dtype), breakdown=jnp.bool_(False), history=history,
        best_res=normb.astype(dtype), stall=jnp.int32(0),
    )
    return state0, normb


def ecg_run(
    a_apply, m_apply, state: "_State", normb: jax.Array, opts: ECGOptions,
    axis_name=None, max_steps: Optional[int] = None,
) -> "_State":
    """Run the iteration loop from `state` until convergence, maxiter, or
    (optionally) max_steps more iterations — the chunked-execution primitive
    behind checkpoint/resume."""
    ops = LAYOUTS[opts.layout]
    if _use_stacked(opts):
        iter_fn = (_iter_omin_stacked if opts.variant == "omin"
                   else _iter_odir_fused_stacked)
    else:
        iter_fn = _ITER_FNS[opts.variant]
    dtype = state.res.dtype
    t = opts.t
    red_tol = (opts.tol * normb / jnp.sqrt(jnp.asarray(float(t), dtype))).astype(dtype)
    tol_abs = (opts.tol * normb).astype(dtype)
    it_stop = state.it + max_steps if max_steps is not None else None

    def cond(s: _State):
        bs = jnp.sum(s.mask)
        ok = (s.res > tol_abs) & (s.it < opts.maxiter) & (bs > 0) & (~s.breakdown)
        if opts.stall_window > 0:
            ok = ok & (s.stall < opts.stall_window)
        if it_stop is not None:
            ok = ok & (s.it < it_stop)
        return ok

    def body(s: _State):
        return iter_fn(s, a_apply, m_apply, axis_name, opts, normb, red_tol, ops)

    return jax.lax.while_loop(cond, body, state)


def ecg_finalize(state: "_State", normb: jax.Array, layout: str = "nt") -> ECGResult:
    """Sum the solution columns (reference: ecg.c:668-677)."""
    ops = LAYOUTS[layout]
    if _is_stacked_state(state):
        t = state.mask.shape[0]
        panel_shape = state.p.shape[1:]
        x_blk = state.x_blk[_SX * t:(_SX + 1) * t].reshape(panel_shape)
    else:
        x_blk = state.x_blk
    return ECGResult(
        x=ops.sum_dirs(x_blk),
        iters=state.it,
        res=state.res,
        normb=normb,
        bs=jnp.sum(state.mask).astype(jnp.int32),
        breakdown=state.breakdown,
        history=state.history,
    )


def ecg_solve(
    a_apply: Callable[[jax.Array], jax.Array],
    m_apply: Optional[Callable[[jax.Array], jax.Array]],
    b: jax.Array,
    opts: ECGOptions,
    axis_name: Optional[str] = None,
    split_assign: Optional[jax.Array] = None,
    x0: Optional[jax.Array] = None,
) -> ECGResult:
    """Solve A x = b. All arrays are LOCAL row panels; inside shard_map pass
    axis_name to reduce across shards (single device: axis_name=None).

    a_apply / m_apply: jittable panel -> panel operator callbacks — the
    functional replacement of the reference's reverse-communication interface
    (reference: src/solvers/ecg.h:116-148 rci_request protocol). Panel shape
    is (m, t) for layout "nt", (t, *space) for layout "tbn"; b is (m,) resp.
    (*space).
    """
    if m_apply is None:
        m_apply = lambda v: v
    if opts.variant not in _ITER_FNS:
        raise ValueError(f"unknown ECG variant {opts.variant!r}")
    if x0 is not None:
        # solve the shifted system A dx = b − A x0 and add x0 back
        # (reference: ecg.c always starts from X=0; x0 is an extension)
        x0 = x0.astype(b.dtype)
        if opts.layout == "nt":
            r0 = b - a_apply(x0[:, None])[:, 0]
        else:
            r0 = b - a_apply(x0[None])[0]
        res = ecg_solve(a_apply, m_apply, r0, opts, axis_name, split_assign)
        return res._replace(x=res.x + x0)
    state0, normb = ecg_init(a_apply, m_apply, b, opts, axis_name, split_assign)
    final = ecg_run(a_apply, m_apply, state0, normb, opts, axis_name)
    return ecg_finalize(final, normb, opts.layout)
