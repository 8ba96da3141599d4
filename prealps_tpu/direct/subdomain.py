"""Batched subdomain factorizations (the PARDISO/MUMPS role).

The reference factors each subdomain's sparse block with a sequential sparse
direct solver per rank (reference: utils/preAlps_solver.c,
mkl_pardiso_solver.c). The batched equivalent here is: RCM-reorder each
block (host), densify, and run ONE batched Cholesky over all blocks — solves
are batched triangular solves. Blocks of unequal size are padded
with an identity tail.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from prealps_tpu.core.partition import rcm_order
from prealps_tpu.precond.block_jacobi import BlockJacobi


def build_block_solver(
    a: sp.spmatrix,
    offsets: np.ndarray,
    rcm: bool = True,
    dtype=None,
) -> BlockJacobi:
    """Exact solver for a block-diagonal SPD matrix with blocks at `offsets`.

    `a` must have no coupling across the given row ranges (e.g. the Aii part
    of a block-arrow matrix, reference: lorasc.c:222-243). Returns a
    BlockJacobi object (same apply machinery) — for a truly block-diagonal
    matrix this is a DIRECT solver, not an approximation.
    """
    a = sp.csr_matrix(a)
    m = a.shape[0]
    nblocks = len(offsets) - 1
    sizes = np.diff(offsets)
    mb = int(sizes.max())
    dtype = dtype or a.dtype

    blocks = np.zeros((nblocks, mb, mb), dtype=dtype)
    gather_idx = np.full(nblocks * mb, m, dtype=np.int32)
    inv_perm = np.empty(m, dtype=np.int32)
    for i in range(nblocks):
        r0, r1 = int(offsets[i]), int(offsets[i + 1])
        sz = r1 - r0
        sub = a[r0:r1, r0:r1]
        if rcm and sz > 2:
            p = rcm_order(sub)
        else:
            p = np.arange(sz)
        blocks[i, :sz, :sz] = sub[p][:, p].toarray()
        blocks[i, sz:, sz:] = np.eye(mb - sz)
        rows = r0 + p
        pos = i * mb + np.arange(sz)
        gather_idx[pos] = rows
        inv_perm[rows] = pos

    factors = np.linalg.cholesky(blocks)
    return BlockJacobi(
        factors=jnp.asarray(factors),
        gather_idx=jnp.asarray(gather_idx),
        inv_perm=jnp.asarray(inv_perm),
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class DenseCholesky:
    """Dense Cholesky solver for one (small) SPD matrix, e.g. the separator
    block Agg (reference: lorasc.c:248-257 factors Agg with MUMPS)."""

    factor: jax.Array  # (n, n) lower

    def tree_flatten(self):
        return (self.factor,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def build(cls, a, dtype=None) -> "DenseCholesky":
        dense = a.toarray() if sp.issparse(a) else np.asarray(a)
        if dtype is not None:
            dense = dense.astype(dtype)
        return cls(factor=jnp.asarray(np.linalg.cholesky(dense)))

    def apply(self, z: jax.Array) -> jax.Array:
        y = jax.lax.linalg.triangular_solve(
            self.factor, z, left_side=True, lower=True, transpose_a=False
        )
        return jax.lax.linalg.triangular_solve(
            self.factor, y, left_side=True, lower=True, transpose_a=True
        )
