"""Direct (sub)domain solvers.

Replaces the reference's sparse-direct wrapper layer (reference:
utils/preAlps_solver.c over MKL-PARDISO / PARDISO / MUMPS) with batched
dense factorizations of reordered subdomain blocks.
"""

from prealps_tpu.direct.subdomain import build_block_solver, DenseCholesky

__all__ = ["build_block_solver", "DenseCholesky"]
