"""Small dense block operations shared by the solvers.

These are the JAX equivalents of the reference's MKL kernel layer used
inside ECG (reference: src/solvers/ecg.c uses LAPACKE dpotrf/dpstrf/dgesvd/
dgeqrf/dormqr + cblas dtrsm on t×t / m×t blocks). All matmuls request
HIGHEST precision so the f32 path uses true f32 products (never TF32).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def f64_traced(fn):
    """Trace `fn` with x64 on, whatever the caller's setting. This is where
    the f32 solve path sums in f64 and rounds once at the end (stencil
    SpMM, double-float residuals, the bj2l coarse solve): every product of
    two f32 values is exact in f64, so such a sum is accurate to the
    rounding of its result."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.enable_x64(True):
            return fn(*args, **kwargs)

    return wrapped


def timing_no_collectives() -> bool:
    """TIMING-ABLATION mode (PREALPS_TIMING_NO_COLLECTIVES=1): every
    collective in the solve becomes a local no-op, so a distributed
    iteration executes exactly its LOCAL compute. Results are WRONG by
    construction — the knob exists solely so weak-scaling measurements can
    separate communication time from core starvation on a shared-core
    virtual mesh (examples/weak_scaling.py). Read at TRACE time."""
    return bool(int(os.environ.get("PREALPS_TIMING_NO_COLLECTIVES", "0")))


def psum(x, axis_name):
    """Cross-shard sum; identity when running single-device (axis_name None)."""
    if axis_name is None or timing_no_collectives():
        return x
    return jax.lax.psum(x, axis_name)


def gram(x: jax.Array, y: jax.Array, axis_name=None) -> jax.Array:
    """(t, s) Gram block xᵀ y with cross-shard reduction."""
    g = jnp.einsum("mt,ms->ts", x, y, precision=HIGHEST)
    return psum(g, axis_name)


def chol_masked(c: jax.Array, mask: jax.Array) -> jax.Array:
    """Upper Cholesky of C restricted to the active prefix given by mask.

    Inactive rows/cols are replaced by identity so the factorization is well
    defined; the corresponding triangular solves then leave masked (zero)
    columns zero. This is the static-shape equivalent of the reference's
    shrinking t (reference: ecg.c dynamic CPLM_MatDenseSetInfo resizing).
    """
    m2 = mask[:, None] * mask[None, :]
    c_act = c * m2 + jnp.diag(1.0 - mask).astype(c.dtype)
    u = jax.lax.linalg.cholesky(c_act.astype(c.dtype), symmetrize_input=True)
    # lax cholesky returns lower; use upper = Lᵀ
    return jnp.swapaxes(u, -1, -2)


def right_tri_solve(u: jax.Array, x: jax.Array) -> jax.Array:
    """X U⁻¹ with U upper triangular (columns transform)."""
    return jax.lax.linalg.triangular_solve(
        u, x, left_side=False, lower=False, transpose_a=False
    )


def tri_inv(u: jax.Array) -> jax.Array:
    """Explicit inverse of a small upper-triangular factor (t×t). Used so
    panel-scale triangular solves become matmuls — a wide-RHS triangular
    solve is slower than a (t×t) inversion + GEMM, and for
    CholQR-grade orthonormalisation the κ² amplification is already present
    in the Gram matrix, so the explicit inverse loses nothing."""
    eye = jnp.eye(u.shape[0], dtype=u.dtype)
    return jax.lax.linalg.triangular_solve(
        u, eye, left_side=True, lower=False, transpose_a=False
    )


def left_trit_solve(u: jax.Array, b: jax.Array) -> jax.Array:
    """U⁻ᵀ B with U upper triangular."""
    return jax.lax.linalg.triangular_solve(
        u, b, left_side=True, lower=False, transpose_a=True
    )


def sym_eigh_small(c: jax.Array):
    return jnp.linalg.eigh(c)


@functools.partial(jax.jit, static_argnames=())
def pivoted_cholesky(c: jax.Array, tol: jax.Array):
    """Rank-revealing upper Cholesky with diagonal pivoting (dpstrf analog).

    Returns (U, piv, rank): C[piv][:, piv] ≈ UᵀU with U upper triangular and
    rank = number of pivots whose residual diagonal exceeded tol (tol<0 uses
    the LAPACK default n*eps*max diag). Small t only — runs as a fori_loop.
    """
    t = c.shape[0]
    eps = jnp.finfo(c.dtype).eps
    tol = jnp.where(tol < 0, t * eps * jnp.max(jnp.diag(c)), tol)

    def body(k, carry):
        a, piv, rank = carry
        d = jnp.diag(a)
        # mask already-processed entries
        idx = jnp.arange(t)
        dm = jnp.where(idx >= k, d, -jnp.inf)
        j = jnp.argmax(dm)
        # swap rows/cols k <-> j
        perm = idx.at[k].set(j).at[j].set(k)
        a = a[perm][:, perm]
        piv = piv[perm]
        pivot = a[k, k]
        ok = pivot > tol
        rank = rank + ok.astype(jnp.int32)
        safe_pivot = jnp.where(ok, pivot, 1.0)
        lkk = jnp.sqrt(safe_pivot)
        row = a[k] / lkk
        row = jnp.where(idx > k, row, 0.0).astype(a.dtype)
        # store U row: a[k, k] = lkk, a[k, k+1:] = row
        a = a.at[k].set(jnp.where(idx == k, jnp.where(ok, lkk, 0.0), jnp.where(ok, row, 0.0)))
        # schur update on trailing block
        upd = jnp.outer(row, row)
        sel = (idx[:, None] > k) & (idx[None, :] > k)
        a = a - jnp.where(sel & ok, upd, 0.0).astype(a.dtype)
        return a, piv, rank

    a0 = c.astype(c.dtype)
    piv0 = jnp.arange(t)
    a, piv, rank = jax.lax.fori_loop(0, t, body, (a0, piv0, jnp.int32(0)))
    u = jnp.triu(a)
    return u, piv, rank
