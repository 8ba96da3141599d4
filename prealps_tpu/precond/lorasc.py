"""LORASC: low-rank-corrected Schur-complement preconditioner.

(reference: src/preconditioners/lorasc.c + lorasc_eigsolve.c.) For an SPD
matrix permuted to block-arrow form

    A_arrow = [ Aii  Aig ]      Aii block-diagonal over k subdomain interiors,
              [ Agi  Agg ]      Agg the (small) separator block,

the preconditioner's approximate inverse is (reference: lorasc.c:368-618):

    M⁻¹ v:  zi = Aii⁻¹ vi
            g  = vg − Agi zi
            zg = Agg⁻¹ g + E diag(σ) Eᵀ g          (low-rank correction)
            wg = zg,  wi = zi − Aii⁻¹ (Aig zg)

where (λ, E) solve the generalized eigenproblem S u = λ Agg u with the Schur
complement S = Agg − Agi Aii⁻¹ Aig, keeping λ ≤ deflation_tol, with
σᵢ = (tol − λᵢ)/λᵢ and E Agg-orthonormal (reference: lorasc_eigsolve.c:238-295;
default deflation_tol 1e-2, lorasc.c:36).

Design choices:
* Aii solves: ONE batched dense Cholesky over RCM-ordered subdomain blocks
  (replaces per-rank PARDISO; direct/subdomain.py).
* Agg solve: dense Cholesky (replaces MUMPS; the separator is small).
* Eigensolve: either a dense generalized eigh on the explicitly assembled S
  (exact, host-side, good up to a few thousand separator rows) or the
  matrix-free jittable Lanczos in ops/lanczos.py (replaces PARPACK).
* Apply: batched trisolves + two ELL SpMMs + two tall GEMMs, fully jittable.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from prealps_tpu.core.partition import BlockArrowStruct, block_arrow_structure, permute
from prealps_tpu.direct.subdomain import DenseCholesky, build_block_solver
from prealps_tpu.ops.blockops import HIGHEST
from prealps_tpu.ops.formats import EllMatrix, csr_to_ell
from prealps_tpu.ops.spmm import ell_spmm
from prealps_tpu.precond.block_jacobi import BlockJacobi


@jax.tree_util.register_pytree_node_class
@dataclass
class Lorasc:
    aii_solver: BlockJacobi
    agg_solver: DenseCholesky
    aig: EllMatrix        # (ni, ng)
    agi: EllMatrix        # (ng, ni)
    e_mat: jax.Array      # (ng, nev) Agg-orthonormal deflation vectors
    sigma: jax.Array      # (nev,)
    ni: int               # interior rows (static)
    ng: int               # separator rows (static)

    def tree_flatten(self):
        children = (
            self.aii_solver, self.agg_solver, self.aig, self.agi,
            self.e_mat, self.sigma,
        )
        return children, (self.ni, self.ng)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, ni=aux[0], ng=aux[1])

    @property
    def nev(self):
        return self.e_mat.shape[1]

    def apply(self, v: jax.Array) -> jax.Array:
        """(ni+ng, t) -> (ni+ng, t), rows in block-arrow order."""
        ni, ng = self.ni, self.ng
        vi, vg = v[:ni], v[ni:]
        # forward sweep (reference: lorasc.c:478-560 "M_L^{-1} v")
        zi = self.aii_solver.apply(vi)
        g = vg - ell_spmm(self.agi, zi)
        corr = jnp.einsum("gk,gt->kt", self.e_mat, g, precision=HIGHEST)
        corr = corr * self.sigma[:, None]
        zg = self.agg_solver.apply(g)
        zg = zg + jnp.einsum("gk,kt->gt", self.e_mat, corr, precision=HIGHEST)
        # backward sweep (reference: lorasc.c:565-615 "M_U^{-1} v")
        wi = zi - self.aii_solver.apply(ell_spmm(self.aig, zg))
        return jnp.concatenate([wi, zg], axis=0)


def schur_complement_dense(
    aii: sp.csr_matrix, aig: sp.csr_matrix, agi: sp.csr_matrix, agg: sp.csr_matrix
) -> np.ndarray:
    """Explicit dense S = Agg − Agi Aii⁻¹ Aig (host, setup only)."""
    w = spla.spsolve(aii.tocsc(), aig.tocsc())
    if sp.issparse(w):
        w = w.toarray()
    w = np.atleast_2d(np.asarray(w))
    if w.shape[0] != aii.shape[0]:
        w = w.T
    s = agg.toarray() - agi @ w
    return 0.5 * (s + s.T)


def build_lorasc(
    a: sp.spmatrix,
    nparts: int = 8,
    deflation_tol: float = 1e-2,
    max_deflation: int = 64,
    eig_method: str = "direct",      # direct | lanczos
    lanczos_ncv: int | None = None,
    arrow: BlockArrowStruct | None = None,
    dtype=None,
) -> tuple[Lorasc, BlockArrowStruct]:
    """Build LORASC for A (original ordering). Returns (precond, arrow).

    The caller must run the solver on the arrow-permuted operator
    permute(A, arrow.perm) — same contract as the reference, whose
    LorascBuild outputs the permuted local matrix for the ECG operator
    (reference: lorasc.h preAlps_LorascBuild locAP output).
    """
    a = sp.csr_matrix(a)
    dtype = np.dtype(dtype) if dtype is not None else a.dtype
    if arrow is None:
        arrow = block_arrow_structure(a, nparts)
    ap = permute(a, arrow.perm)
    ni, n = arrow.sep_start, arrow.n
    ng = n - ni

    aii = ap[:ni, :ni].tocsr()
    aig = ap[:ni, ni:].tocsr()
    agi = ap[ni:, :ni].tocsr()
    agg = ap[ni:, ni:].tocsr()

    aii_solver = build_block_solver(aii, arrow.interior_offsets, dtype=dtype)
    agg_solver = DenseCholesky.build(agg, dtype=dtype)

    # --- deflation eigenproblem S u = λ Agg u ---
    if eig_method == "direct":
        s_dense = schur_complement_dense(aii, aig, agi, agg)
        lam, vecs = scipy.linalg.eigh(s_dense, agg.toarray())
    elif eig_method == "lanczos":
        lam, vecs = _lanczos_eigs(
            aii_solver, agg_solver, aig, agi, agg, ni, ng,
            ncv=lanczos_ncv or min(ng, 2 * max_deflation + 1), dtype=dtype,
        )
    else:
        raise ValueError(f"unknown eig_method {eig_method!r}")

    sel = np.flatnonzero(lam <= deflation_tol)[:max_deflation]
    if sel.size == 0:
        # keep a single zero-weight vector so shapes stay non-degenerate
        e_mat = np.zeros((ng, 1))
        sigma = np.zeros((1,))
    else:
        e_mat = np.asarray(vecs)[:, sel]
        lam_sel = np.asarray(lam)[sel]
        sigma = (deflation_tol - lam_sel) / lam_sel  # reference: lorasc_eigsolve.c:247

    precond = Lorasc(
        aii_solver=aii_solver,
        agg_solver=agg_solver,
        aig=csr_to_ell(aig, dtype=dtype),
        agi=csr_to_ell(agi, dtype=dtype),
        e_mat=jnp.asarray(e_mat, dtype=dtype),
        sigma=jnp.asarray(sigma, dtype=dtype),
        ni=ni,
        ng=ng,
    )
    return precond, arrow


def _lanczos_eigs(aii_solver, agg_solver, aig, agi, agg, ni, ng, ncv, dtype):
    """Matrix-free path: Lanczos on OP = Agg⁻¹ S in the Agg-inner product
    (replaces PARPACK mode 2; reference: utils/matrixVectorOp.c AggInvxS)."""
    from prealps_tpu.ops.lanczos import lanczos_gen

    aig_e = csr_to_ell(aig, dtype=dtype)
    agi_e = csr_to_ell(agi, dtype=dtype)
    agg_e = csr_to_ell(agg, dtype=dtype)

    def s_apply(v):  # S v = Agg v − Agi Aii⁻¹ Aig v
        u = ell_spmm(aig_e, v[:, None])
        u = aii_solver.apply(u)
        u = ell_spmm(agi_e, u)
        return (ell_spmm(agg_e, v[:, None]) - u)[:, 0]

    def op_apply(v):  # Agg⁻¹ S v
        return agg_solver.apply(s_apply(v)[:, None])[:, 0]

    def b_apply(v):
        return ell_spmm(agg_e, v[:, None])[:, 0]

    res = jax.jit(
        lambda: lanczos_gen(op_apply, b_apply, ng, ncv, dtype=jnp.dtype(dtype))
    )()
    return np.asarray(res.eigvalues), np.asarray(res.eigvectors)
