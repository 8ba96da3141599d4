"""Chebyshev (polynomial) preconditioner — an addition to the reference.

Not in the reference (whose preconditioners are all factorization-based via
MKL-PARDISO/MUMPS). On an accelerator, subdomain factorizations cost device memory and
host→device transfer, while SpMM is cheap and already resident; a degree-d
Chebyshev polynomial in the Jacobi-scaled operator is an M⁻¹ apply of d
SpMMs with ZERO extra memory — often the better wall-clock trade on this
hardware. Offered alongside block-Jacobi/LORASC/PRESC for capability parity
plus a hardware-fit option.

M⁻¹ ≈ p_d(D⁻¹A) D⁻¹ with p_d the Chebyshev polynomial minimising the
residual on [λ_min, λ_max] (standard three-term recurrence); λ_max is
estimated with a few power iterations, λ_min set to λ_max/kappa_bound.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp


def cheby_recurrence(op, b, degree: int, lam_min, lam_max):
    """x ≈ op⁻¹ b by `degree` steps of the Chebyshev iteration on the
    spectrum [lam_min, lam_max] of `op` (standard three-term recurrence;
    degree-1 operator applications after the initial residual). Uses a
    fori_loop so the traced graph stays small regardless of degree.
    Layout-agnostic: works on any panel shape `op` and `b` agree on."""
    theta = (lam_max + lam_min) / 2.0
    delta = (lam_max - lam_min) / 2.0
    sigma1 = theta / delta
    dvec = b / theta
    x = dvec
    if degree <= 1:
        return x
    res = b - op(x)
    rho0 = jnp.asarray(1.0 / sigma1, b.dtype)

    def body(k, carry):
        x, dvec, res, rho_prev = carry
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        dvec = rho * rho_prev * dvec + (2.0 * rho / delta) * res
        x = x + dvec
        res = res - op(dvec)
        return (x, dvec, res, rho)

    x, dvec, res, rho_prev = jax.lax.fori_loop(
        0, degree - 2, body, (x, dvec, res, rho0)
    )
    # final step (no residual update needed)
    rho = 1.0 / (2.0 * sigma1 - rho_prev)
    dvec = rho * rho_prev * dvec + (2.0 * rho / delta) * res
    return x + dvec


def power_lam_max_host(a, iters: int = 30) -> float:
    """Host-side power iteration for lam_max(D⁻¹A) (scipy, setup time)."""
    import numpy as _np
    import scipy.sparse as _sp

    a = _sp.csr_matrix(a)
    d_inv = 1.0 / a.diagonal()
    v = _np.ones(a.shape[0])
    v /= _np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = d_inv * (a @ v)
        lam = _np.linalg.norm(w)
        v = w / lam
    return float(lam)


@jax.tree_util.register_pytree_node_class
@dataclass
class Chebyshev:
    inv_diag: jax.Array   # (m,) D⁻¹
    lam_min: jax.Array    # scalar
    lam_max: jax.Array    # scalar
    degree: int
    a_apply: Callable     # static: jittable (m,t)->(m,t) operator

    def tree_flatten(self):
        return (self.inv_diag, self.lam_min, self.lam_max), (self.degree, self.a_apply)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux[0], aux[1])

    def apply(self, r: jax.Array) -> jax.Array:
        """Approximate A⁻¹ r by the Chebyshev iteration on the Jacobi-scaled
        operator (three-term recurrence, `degree` operator applications)."""
        d_inv = self.inv_diag[:, None]

        def op(v):  # D⁻¹ A v — SPD under the D-inner product
            return d_inv * self.a_apply(v)

        return cheby_recurrence(op, d_inv * r, self.degree, self.lam_min, self.lam_max)


def estimate_lam_max(a_apply, inv_diag, m, iters: int = 20, dtype=jnp.float32):
    """Power iteration on D⁻¹A (jittable, deterministic start)."""
    v = jnp.ones((m, 1), dtype)

    def body(_, carry):
        v, lam = carry
        w = inv_diag[:, None] * a_apply(v)
        lam = jnp.linalg.norm(w)
        return w / lam, lam

    v, lam = jax.lax.fori_loop(0, iters, body, (v / jnp.linalg.norm(v), jnp.asarray(1.0, dtype)))
    return lam


def build_chebyshev(
    a_apply, diag, degree: int = 8, kappa_bound: float = 30.0, lam_max=None
) -> Chebyshev:
    """diag: (m,) diagonal of A (host or device array)."""
    inv_diag = 1.0 / jnp.asarray(diag)
    m = inv_diag.shape[0]
    if lam_max is None:
        lam_max = estimate_lam_max(a_apply, inv_diag, m, dtype=inv_diag.dtype)
    lam_max = jnp.asarray(lam_max, inv_diag.dtype) * 1.05
    lam_min = lam_max / kappa_bound
    return Chebyshev(
        inv_diag=inv_diag, lam_min=lam_min, lam_max=lam_max,
        degree=degree, a_apply=a_apply,
    )
