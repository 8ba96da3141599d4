"""Panel layout abstraction for the ECG state.

Two layouts for the (n × t) tall-skinny solver panels:

* "nt"  — rows-major (n, t): the natural mathematical layout; fine on CPU
  and for f64 correctness runs.
* "tbn" — lane-major (t, br, nrb) with the long node axis MINOR: every
  elementwise solver update and every load of the stencil SpMM is then
  contiguous along nodes, whatever t is (the layout the Triton stencil
  kernel reads, ops/spmm.py).

Every layout-dependent operation ECG needs is routed through one of these
two namespaces; the solver algebra in ecg.py is layout-blind.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


class NT:
    """Rows-major (m, t) panels."""

    name = "nt"

    @staticmethod
    def gram(x, y):
        """(t, s) block xᵀy."""
        return jnp.einsum("mt,ms->ts", x, y, precision=HIGHEST)

    @staticmethod
    def update(x, p, coef):
        """x + p·coef with coef (d, r): combine direction columns."""
        return x + jnp.einsum("md,dr->mr", p, coef, precision=HIGHEST)

    @staticmethod
    def downdate(x, p, coef):
        return x - jnp.einsum("md,dr->mr", p, coef, precision=HIGHEST)

    @staticmethod
    def right_solve(u, p):
        """P U⁻¹ (mix direction columns by the inverse factor)."""
        return jax.lax.linalg.triangular_solve(
            u, p, left_side=False, lower=False, transpose_a=False
        )

    @staticmethod
    def rotate(p, q):
        """P Q (direction mixing by an orthogonal t×t Q)."""
        return jnp.einsum("mt,ts->ms", p, q, precision=HIGHEST)

    mix = rotate  # same operation: right-multiply by a small matrix

    @staticmethod
    def scale_dirs(p, mask):
        return p * mask[None, :]

    @staticmethod
    def sum_dirs(x_blk):
        return jnp.sum(x_blk, axis=1)

    @staticmethod
    def split(b, t, assign):
        onehot = jax.nn.one_hot(assign, t, dtype=b.dtype)
        return onehot * b[:, None]

    @staticmethod
    def zeros_like_panel(b, t):
        return jnp.zeros(b.shape + (t,), b.dtype)

    @staticmethod
    def take_dirs(p, idx):
        return p[:, idx]


class TBN:
    """Lane-major (t, *space) panels; space is typically (br, nrb)."""

    name = "tbn"

    @staticmethod
    def gram(x, y):
        return jnp.einsum("t...,s...->ts", x, y, precision=HIGHEST)

    @staticmethod
    def update(x, p, coef):
        return x + jnp.einsum("d...,dr->r...", p, coef, precision=HIGHEST)

    @staticmethod
    def downdate(x, p, coef):
        return x - jnp.einsum("d...,dr->r...", p, coef, precision=HIGHEST)

    @staticmethod
    def right_solve(u, p):
        """(P U⁻¹) in lane-major is U⁻ᵀ applied on the left: solve Uᵀ X = P."""
        t = p.shape[0]
        flat = p.reshape(t, -1)
        out = jax.lax.linalg.triangular_solve(
            u, flat, left_side=True, lower=False, transpose_a=True
        )
        return out.reshape(p.shape)

    @staticmethod
    def rotate(p, q):
        return jnp.einsum("d...,dr->r...", p, q, precision=HIGHEST)

    mix = rotate  # same operation: right-multiply by a small matrix

    @staticmethod
    def scale_dirs(p, mask):
        return p * mask.reshape((-1,) + (1,) * (p.ndim - 1))

    @staticmethod
    def sum_dirs(x_blk):
        return jnp.sum(x_blk, axis=0)

    @staticmethod
    def split(b, t, assign):
        """b: (*space); assign: (*space) int32 -> (t, *space)."""
        tt = jnp.arange(t).reshape((t,) + (1,) * b.ndim)
        return jnp.where(assign[None] == tt, b[None], 0).astype(b.dtype)

    @staticmethod
    def zeros_like_panel(b, t):
        return jnp.zeros((t,) + b.shape, b.dtype)

    @staticmethod
    def take_dirs(p, idx):
        return p[idx]


LAYOUTS = {"nt": NT, "tbn": TBN}
