"""Double-float (compensated f32) arithmetic building blocks.

For f32 solves, this module provides error-free transformations
(Knuth two-sum, Dekker split/two-prod) and compensated reductions that give
~2x f32 precision (≈ 49-bit mantissa) using pairs (hi, lo) of f32 values.
Used where a single f32 reduction is the accuracy bottleneck (residual
norms, dot products) — complementing the framework's main mixed-precision
mechanism, host-f64 iterative refinement (parallel/driver.py).

All functions are jittable and elementwise-vectorised.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _barrier(x):
    """Pin a value against XLA excess-precision rewrites.

    Error-free transforms REQUIRE the rounded f32 product/sum to exist: under
    jit, XLA (xla_allow_excess_precision, on by default) fuses `a*b` into a
    following add as a single-rounding FMA, which silently breaks two_prod /
    Dekker split (measured: df accumulation degrades from ~1e-12 to ~1e-7,
    i.e. back to plain f32). An optimization barrier on the product forces
    the intermediate rounding. Negligible cost at df call sites (one extra
    materialisation of an already-needed value)."""
    return jax.lax.optimization_barrier(x)


def two_sum(a, b):
    """Error-free a+b: returns (s, err) with s+err == a+b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """Dekker split: a = hi + lo with hi, lo having ≤12 significant bits."""
    c = _barrier(jnp.float32(4097.0) * a)
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a*b: returns (p, err) with p+err == a*b exactly (f32)."""
    p = _barrier(a * b)
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def df_add(x, y):
    """(hi,lo) + (hi,lo) -> (hi,lo)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + xl + yl
    hi, lo = two_sum(s, e)
    return hi, lo


def df_sum(values_hi, values_lo=None):
    """Compensated sum of an array along its FLATTENED elements.

    Pairwise tree reduction in double-float arithmetic: O(log n) vector
    steps, error O(eps²·n) instead of O(eps·sqrt(n))."""
    hi = values_hi.ravel()
    lo = jnp.zeros_like(hi) if values_lo is None else values_lo.ravel()
    n = hi.shape[0]
    # pad to a power of two
    size = 1 << max(int(n - 1).bit_length(), 0)
    pad = size - n
    if pad:
        hi = jnp.concatenate([hi, jnp.zeros((pad,), hi.dtype)])
        lo = jnp.concatenate([lo, jnp.zeros((pad,), lo.dtype)])
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        hi, lo = df_add((hi[:half], lo[:half]), (hi[half:], lo[half:]))
    return hi[0], lo[0]


def df_dot(x, y):
    """Compensated dot product of flattened x·y; returns (hi, lo)."""
    p, e = two_prod(x.ravel(), y.ravel())
    return df_sum(p, e)


def df_norm(x):
    """Compensated 2-norm of x (scalar f32, ~f64-accurate)."""
    hi, lo = df_dot(x, x)
    # sqrt(hi+lo) ≈ sqrt(hi)·(1 + lo/(2 hi))
    s = jnp.sqrt(hi)
    return jnp.where(hi > 0, s * (1.0 + lo / (2.0 * jnp.maximum(hi, 1e-30))), 0.0)
