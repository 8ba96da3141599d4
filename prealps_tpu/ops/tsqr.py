"""TSQR: communication-avoiding tall-skinny QR by binary reduction tree.

JAX replacement for the tall-skinny QR factorizations the reference's
tournament-pivoting kernels do with SuiteSparseQR (reference:
utils/iterativeKernels/tournamentPivoting.c:35-40) and the CholQR variants in
utils/cholqr.c. The reduction-tree structure maps perfectly onto a device
mesh: local QR per block, stack pairs of R factors, QR again, repeat —
log2(nblocks) levels, each a small (2t × t) factorization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from prealps_tpu.ops.blockops import HIGHEST


def tsqr_r(x: jax.Array, nblocks: int = 8) -> jax.Array:
    """R factor of x (m, t) via a local binary reduction tree.

    Returns upper-triangular R (t, t) with A = QR (Q not formed). Sign
    convention: R has non-negative diagonal.
    """
    m, t = x.shape
    nblocks = max(1, min(nblocks, m // max(t, 1)))
    # pad rows so blocks are equal
    mb = -(-m // nblocks)
    pad = nblocks * mb - m
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, t), x.dtype)], axis=0)
    blocks = x.reshape(nblocks, mb, t)
    _, r = jnp.linalg.qr(blocks)  # (nblocks, t, t)
    while r.shape[0] > 1:
        nb = r.shape[0]
        if nb % 2 == 1:
            r = jnp.concatenate([r, jnp.zeros((1, t, t), r.dtype)], axis=0)
            nb += 1
        paired = r.reshape(nb // 2, 2 * t, t)
        _, r = jnp.linalg.qr(paired)
    r = r[0]
    # fix signs for a unique factor
    s = jnp.sign(jnp.diag(r))
    s = jnp.where(s == 0, 1.0, s)
    return r * s[:, None]


def tsqr(x: jax.Array, nblocks: int = 8):
    """Full TSQR: returns (Q, R) with Q (m, t) orthonormal, A = QR.

    Q is recovered as X R⁻¹ with one refinement pass (numerically fine for
    the well-conditioned panels Krylov methods produce; for nearly singular
    panels use tsqr_r + explicit column handling).
    """
    r = tsqr_r(x, nblocks)
    q = jax.lax.linalg.triangular_solve(r, x, left_side=False, lower=False)
    # one reorthogonalisation pass (CholQR2-style)
    r2 = tsqr_r(q, nblocks)
    q = jax.lax.linalg.triangular_solve(r2, q, left_side=False, lower=False)
    return q, jnp.einsum("ij,jk->ik", r2, r, precision=HIGHEST)


def tsqr_r_distributed(x_loc: jax.Array, axis_name: str) -> jax.Array:
    """R factor across shards: local R factors all-gathered, then one stacked
    QR — the cross-device level of the reduction tree (one collective)."""
    r_loc = tsqr_r(x_loc, nblocks=4)
    r_all = jax.lax.all_gather(r_loc, axis_name, axis=0, tiled=False)
    nsh, t, _ = r_all.shape
    _, r = jnp.linalg.qr(r_all.reshape(nsh * t, t))
    s = jnp.sign(jnp.diag(r))
    s = jnp.where(s == 0, 1.0, s)
    return r * s[:, None]
