"""Batched block-banded Cholesky — the sparse-direct subdomain solver at scale.

The reference factors each subdomain's sparse diagonal block with a serial
sparse direct solver (reference: src/preconditioners/block_jacobi.c:48-58,
utils/mkl_pardiso_solver.c:95-141, and LORASC's Aii factorization at
src/preconditioners/lorasc.c:222-243). JAX has no PARDISO; the round-1
answer (densify + batched dense Cholesky) capped blocks at ~1-2k rows.

This module lifts that cap: after a (host-side) bandwidth-reducing ordering,
each subdomain matrix is **banded** with half-bandwidth ≤ bs, i.e.
block-tridiagonal with bs×bs blocks:

        [ D_0  E_1ᵀ            ]
    A = [ E_1  D_1  E_2ᵀ       ]     D_i SPD-part diagonal blocks,
        [      E_2  D_2   ...  ]     E_i subdiagonal coupling blocks.

Factorization (batched over subdomains, lax.scan over the block index —
nblk ≈ n/bs sequential steps of large batched matmuls):

    M_i = E_i L_{i-1}⁻ᵀ ;  S_i = D_i − M_i M_iᵀ ;  L_i = chol(S_i)

storing L_i⁻¹ explicitly (so solves become pure GEMMs instead of
wide-RHS triangular solves):

    forward:   y_i = L_i⁻¹ (v_i − M_i y_{i-1})
    backward:  w_i = L_i⁻ᵀ (y_i − M_{i+1}ᵀ w_{i+1})

Memory = 2·n·bs floats total — n·band, the same asymptotics as a banded
direct solver, vs n²/P for the dense path.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# host-side planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BandPlan:
    """Host-side description of a batched block-banded system.

    nparts subdomains, each padded to nblk·bs rows. `perm[p]` maps band
    position -> caller row index within part p (−1 on padding); `bandwidth`
    is the max half-bandwidth after ordering (must be ≤ bs).
    """

    nparts: int
    nblk: int
    bs: int
    bandwidth: int
    perm: np.ndarray       # (nparts, nblk*bs) band pos -> part-local row, -1 pad
    inv_perm: np.ndarray   # (nparts, nblk*bs) part-local row -> band pos (pad tail)
    sizes: np.ndarray      # (nparts,) true rows per part

    @property
    def rows_padded(self) -> int:
        return self.nblk * self.bs


def plan_block_banded(
    blocks: list[sp.spmatrix],
    bs: int | None = None,
    order: str = "rcm",
    bs_multiple: int = 8,
) -> BandPlan:
    """Choose a bandwidth-reducing ordering per block and a uniform bs.

    `blocks` are the subdomain matrices (one per part, any sizes). With
    order="rcm" each block is RCM-ordered first (reference uses the direct
    solver's fill-reducing ordering for the same purpose); order="natural"
    keeps the given order (right when the caller's order is already banded,
    e.g. lexicographic grid interiors).
    """
    from prealps_tpu.core.partition import rcm_order

    nparts = len(blocks)
    perms = []
    bandwidth = 1
    sizes = np.array([b.shape[0] for b in blocks], dtype=np.int64)
    for b in blocks:
        b = sp.csr_matrix(b)
        m = b.shape[0]
        p = rcm_order(b) if (order == "rcm" and m > 2) else np.arange(m)
        coo = b[p][:, p].tocoo()
        if coo.nnz:
            bandwidth = max(bandwidth, int(np.abs(coo.row - coo.col).max()))
        perms.append(p)
    if bs is None:
        bs = -(-max(bandwidth, 1) // bs_multiple) * bs_multiple
    bs = max(bs, bs_multiple)
    if bandwidth > bs:
        raise ValueError(f"bandwidth {bandwidth} exceeds block size {bs}")
    nblk = max(1, -(-int(sizes.max()) // bs))

    rows = nblk * bs
    perm = np.full((nparts, rows), -1, dtype=np.int64)
    inv_perm = np.zeros((nparts, rows), dtype=np.int64)
    for i, p in enumerate(perms):
        m = p.shape[0]
        perm[i, :m] = p
        inv = np.empty(m, dtype=np.int64)
        inv[p] = np.arange(m)
        inv_perm[i, :m] = inv
        inv_perm[i, m:] = np.arange(m, rows)
    return BandPlan(
        nparts=nparts, nblk=nblk, bs=bs, bandwidth=bandwidth,
        perm=perm, inv_perm=inv_perm, sizes=sizes,
    )


def assemble_host(plan: BandPlan, blocks: list[sp.spmatrix], dtype=np.float64):
    """Assemble (D, E) numpy arrays from the subdomain matrices (host path;
    the device path scatters directly from resident operator data).

    D: (nparts, nblk, bs, bs) diagonal blocks (full, symmetric);
    E: (nparts, nblk, bs, bs) subdiagonal blocks (E[0] = 0).
    Padding rows carry an identity diagonal.
    """
    P, nblk, bs = plan.nparts, plan.nblk, plan.bs
    d = np.zeros((P, nblk, bs, bs), dtype=dtype)
    e = np.zeros((P, nblk, bs, bs), dtype=dtype)
    for i, b in enumerate(blocks):
        m = b.shape[0]
        p = plan.perm[i, :m]
        coo = sp.csr_matrix(b)[p][:, p].tocoo()
        rb, cb = coo.row // bs, coo.col // bs
        rl, cl = coo.row % bs, coo.col % bs
        same = rb == cb
        np.add.at(d[i], (rb[same], rl[same], cl[same]), coo.data[same])
        sub = rb == cb + 1
        np.add.at(e[i], (rb[sub], rl[sub], cl[sub]), coo.data[sub])
        # identity on padding
        pad = np.arange(m, plan.rows_padded)
        d[i, pad // bs, pad % bs, pad % bs] = 1.0
    return d, e


# ---------------------------------------------------------------------------
# device: factorization + solves
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass
class BlockBandedCholesky:
    """Factored batched block-banded SPD matrix (see module docstring)."""

    l_inv: jax.Array   # (P, nblk, bs, bs) inverted diagonal Cholesky factors
    m_off: jax.Array   # (P, nblk, bs, bs) subdiagonal factors, M[0] = 0
    failed: jax.Array  # () bool — any Cholesky produced NaN

    def tree_flatten(self):
        return (self.l_inv, self.m_off, self.failed), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def solve(self, v: jax.Array) -> jax.Array:
        """v: (P, nblk, bs, t) -> (P, nblk, bs, t)."""
        return block_banded_solve(self, v)


def block_banded_cholesky(
    d: jax.Array, e: jax.Array, shift: float = 0.0
) -> BlockBandedCholesky:
    """Factor the batched block-banded matrix given by (D, E) on device.

    `shift` adds shift·diag(D_i) before factoring — a robustness knob for
    float32 builds of ill-conditioned operators (a preconditioner tolerates
    the perturbation; an exact solve should pass shift=0).
    """
    P, nblk, bs, _ = d.shape
    dtype = d.dtype
    # shift may be a traced scalar (drivers retry with growing shifts under
    # one jit); applying a 0.0 shift is free, so no static branch
    diag = jnp.einsum("pnii->pni", d)
    d = d + jnp.asarray(shift, dtype) * jax.vmap(jax.vmap(jnp.diag))(diag)
    eye = jnp.broadcast_to(jnp.eye(bs, dtype=dtype), (P, bs, bs))

    def step(l_inv_prev, de):
        d_i, e_i = de  # (P, bs, bs) each
        m_i = jnp.einsum("pij,pkj->pik", e_i, l_inv_prev, precision=HIGHEST)
        s_i = d_i - jnp.einsum("pik,pjk->pij", m_i, m_i, precision=HIGHEST)
        l_i = jax.lax.linalg.cholesky(s_i, symmetrize_input=True)
        l_i = jnp.where(jnp.isnan(l_i), jnp.zeros_like(l_i), l_i)
        l_inv = jax.lax.linalg.triangular_solve(
            l_i, eye, left_side=True, lower=True
        )
        bad = jnp.any(jnp.isnan(l_inv)) | jnp.any(jnp.isinf(l_inv))
        l_inv = jnp.where(bad, jnp.zeros_like(l_inv), l_inv)
        return l_inv, (l_inv, m_i, bad)

    # scan over the block index; E[:, 0] is zero so M_0 = 0 regardless of init
    d_t = jnp.swapaxes(d, 0, 1)  # (nblk, P, bs, bs)
    e_t = jnp.swapaxes(e, 0, 1)
    _, (l_inv, m_off, bad) = jax.lax.scan(step, jnp.zeros_like(eye), (d_t, e_t))
    return BlockBandedCholesky(
        l_inv=jnp.swapaxes(l_inv, 0, 1),
        m_off=jnp.swapaxes(m_off, 0, 1),
        failed=jnp.any(bad),
    )


def block_banded_solve(
    fac: BlockBandedCholesky, v: jax.Array, unroll: int | bool = True
) -> jax.Array:
    """Solve A w = v for the factored block-banded A. v: (P, nblk, bs, t).

    unroll: passed to lax.scan. The recurrence is bandwidth-bound (each step
    streams two (P, bs, bs) factor blocks for a skinny GEMM), so unrolling
    lets XLA software-pipeline the next step's factor loads behind the
    current step's FMAs instead of paying a serial dispatch per block.
    """
    l_inv = jnp.swapaxes(fac.l_inv, 0, 1)  # (nblk, P, bs, bs)
    m_off = jnp.swapaxes(fac.m_off, 0, 1)
    v_t = jnp.swapaxes(v, 0, 1)            # (nblk, P, bs, t)
    P, bs, t = v_t.shape[1], v_t.shape[2], v_t.shape[3]
    zero = jnp.zeros((P, bs, t), v.dtype)

    def fwd(y_prev, inp):
        l_inv_i, m_i, v_i = inp
        rhs = v_i - jnp.einsum("pij,pjt->pit", m_i, y_prev, precision=HIGHEST)
        y_i = jnp.einsum("pij,pjt->pit", l_inv_i, rhs, precision=HIGHEST)
        return y_i, y_i

    _, y = jax.lax.scan(fwd, zero, (l_inv, m_off, v_t), unroll=unroll)

    # backward: w_i = L_i⁻ᵀ (y_i − M_{i+1}ᵀ w_{i+1}); scan from the last block
    m_next = jnp.concatenate([m_off[1:], jnp.zeros_like(m_off[:1])], axis=0)

    def bwd(w_next, inp):
        l_inv_i, m_n, y_i = inp
        rhs = y_i - jnp.einsum("pji,pjt->pit", m_n, w_next, precision=HIGHEST)
        w_i = jnp.einsum("pji,pjt->pit", l_inv_i, rhs, precision=HIGHEST)
        return w_i, w_i

    _, w = jax.lax.scan(bwd, zero, (l_inv, m_next, y), reverse=True,
                        unroll=unroll)
    return jnp.swapaxes(w, 0, 1)


def block_banded_solve_t(
    fac: BlockBandedCholesky, v3: jax.Array, unroll: int | bool = True
) -> jax.Array:
    """t-major variant of block_banded_solve: v3 (nblk, P, t, bs).

    (…, t, bs) keeps the long bs axis minor in every scan step instead of
    t≈12. Factors are unchanged — identical
    math to block_banded_solve, different vector einsum orientation."""
    l_inv = jnp.swapaxes(fac.l_inv, 0, 1)   # (nblk, P, bs, bs)
    m_off = jnp.swapaxes(fac.m_off, 0, 1)
    P, t, bs = v3.shape[1], v3.shape[2], v3.shape[3]
    zero = jnp.zeros((P, t, bs), v3.dtype)

    def fwd(y_prev, inp):
        l_inv_i, m_i, v_i = inp
        rhs = v_i - jnp.einsum("pij,ptj->pti", m_i, y_prev, precision=HIGHEST)
        y_i = jnp.einsum("pij,ptj->pti", l_inv_i, rhs, precision=HIGHEST)
        return y_i, y_i

    _, y = jax.lax.scan(fwd, zero, (l_inv, m_off, v3), unroll=unroll)

    m_next = jnp.concatenate([m_off[1:], jnp.zeros_like(m_off[:1])], axis=0)

    def bwd(w_next, inp):
        l_inv_i, m_n, y_i = inp
        rhs = y_i - jnp.einsum("pji,ptj->pti", m_n, w_next, precision=HIGHEST)
        w_i = jnp.einsum("pji,ptj->pti", l_inv_i, rhs, precision=HIGHEST)
        return w_i, w_i

    _, w = jax.lax.scan(bwd, zero, (l_inv, m_next, y), reverse=True,
                        unroll=unroll)
    return w


def block_banded_matvec(d: jax.Array, e: jax.Array, v: jax.Array) -> jax.Array:
    """y = A v for the block-banded (D, E) operator. v: (P, nblk, bs, t)."""
    y = jnp.einsum("pnij,pnjt->pnit", d, v, precision=HIGHEST)
    lower = jnp.einsum("pnij,pnjt->pnit", e[:, 1:], v[:, :-1], precision=HIGHEST)
    upper = jnp.einsum("pnji,pnjt->pnit", e[:, 1:], v[:, 1:], precision=HIGHEST)
    y = y.at[:, 1:].add(lower)
    y = y.at[:, :-1].add(upper)
    return y


# ---------------------------------------------------------------------------
# convenience: vectors <-> band layout
# ---------------------------------------------------------------------------

def to_band(plan: BandPlan, parts: list[np.ndarray]) -> np.ndarray:
    """Per-part vectors/panels -> (P, nblk, bs, t) band layout (host)."""
    t = parts[0].shape[1] if parts[0].ndim > 1 else 1
    out = np.zeros((plan.nparts, plan.rows_padded, t))
    for i, v in enumerate(parts):
        v2 = v.reshape(v.shape[0], -1)
        out[i, : v2.shape[0]] = v2[plan.perm[i, : v2.shape[0]]]
    return out.reshape(plan.nparts, plan.nblk, plan.bs, t)


def from_band(plan: BandPlan, w: jax.Array) -> list[np.ndarray]:
    """(P, nblk, bs, t) -> per-part vectors in caller order (host)."""
    w = np.asarray(w).reshape(plan.nparts, plan.rows_padded, -1)
    outs = []
    for i in range(plan.nparts):
        m = int(plan.sizes[i])
        out = np.empty((m, w.shape[2]))
        out[plan.perm[i, :m]] = w[i, :m]
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# two-level: solve with block rows sharded over an inner mesh axis
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass
class BlockBandedCholesky2L:
    """Block-banded factors prepared for an inner ("local") mesh axis.

    The sequential block recursion stays, but each step's GEMMs are
    row-sharded over the inner axis (the reference's localLevel analog:
    the per-group MPI ranks collaborating on one MUMPS Aii solve,
    reference: src/preconditioners/lorasc.c:222-243). The cross-step
    couplings are folded into precomputed products so each step needs ONE
    in-group all_gather:

      forward:  y_i = L_i⁻¹ v_i − (L_i⁻¹ M_i) y_{i−1}
      backward: w_i = L_i⁻ᵀ y_i − (L_i⁻ᵀ M_{i+1}ᵀ) w_{i+1}
    """

    l_inv: jax.Array    # (P, nblk, bs, bs)
    w_fwd: jax.Array    # (P, nblk, bs, bs) = L_i⁻¹ M_i
    l_inv_t: jax.Array  # (P, nblk, bs, bs) = L_i⁻ᵀ
    w_bwd: jax.Array    # (P, nblk, bs, bs) = L_i⁻ᵀ M_{i+1}ᵀ

    def tree_flatten(self):
        return (self.l_inv, self.w_fwd, self.l_inv_t, self.w_bwd), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def prepare_two_level(fac: BlockBandedCholesky) -> BlockBandedCholesky2L:
    """Fold the factors for the row-sharded solve (build-time, on device)."""
    l_inv, m_off = fac.l_inv, fac.m_off
    w_fwd = jnp.einsum("pnij,pnjk->pnik", l_inv, m_off, precision=HIGHEST)
    l_inv_t = jnp.swapaxes(l_inv, -1, -2)
    m_next = jnp.concatenate(
        [m_off[:, 1:], jnp.zeros_like(m_off[:, :1])], axis=1
    )
    w_bwd = jnp.einsum(
        "pnij,pnkj->pnik", l_inv_t, m_next, precision=HIGHEST
    )
    return BlockBandedCholesky2L(
        l_inv=l_inv, w_fwd=w_fwd, l_inv_t=l_inv_t, w_bwd=w_bwd
    )


def block_banded_solve_two_level(
    fac2: BlockBandedCholesky2L, v: jax.Array, axis_name: str, n_local: int
) -> jax.Array:
    """Row-sharded solve inside shard_map over the inner axis.

    fac2 arrays arrive SHARDED on their bs (row) axis: (P, nblk, bs/L, bs).
    v arrives REPLICATED in-group: (P, nblk, bs, t). Returns the full
    replicated solution (P, nblk, bs, t) — one in-group all_gather per block
    step.
    """
    l_inv = jnp.swapaxes(fac2.l_inv, 0, 1)      # (nblk, P, bs/L, bs)
    w_fwd = jnp.swapaxes(fac2.w_fwd, 0, 1)
    l_inv_t = jnp.swapaxes(fac2.l_inv_t, 0, 1)
    w_bwd = jnp.swapaxes(fac2.w_bwd, 0, 1)
    v_t = jnp.swapaxes(v, 0, 1)                 # (nblk, P, bs, t)
    p_n, bs, t = v_t.shape[1], v_t.shape[2], v_t.shape[3]

    def gather(y_chunk):
        # (P, bs/L, t) -> (P, bs, t), in-group
        return jax.lax.all_gather(
            y_chunk, axis_name, axis=1, tiled=True
        )

    zero = jnp.zeros((p_n, bs, t), v.dtype)

    def fwd(y_prev, inp):
        l_i, w_i, v_i = inp
        y_chunk = (
            jnp.einsum("pij,pjt->pit", l_i, v_i, precision=HIGHEST)
            - jnp.einsum("pij,pjt->pit", w_i, y_prev, precision=HIGHEST)
        )
        y_i = gather(y_chunk)
        return y_i, y_i

    _, y = jax.lax.scan(fwd, zero, (l_inv, w_fwd, v_t))

    def bwd(w_next, inp):
        lt_i, wb_i, y_i = inp
        w_chunk = (
            jnp.einsum("pij,pjt->pit", lt_i, y_i, precision=HIGHEST)
            - jnp.einsum("pij,pjt->pit", wb_i, w_next, precision=HIGHEST)
        )
        w_i = gather(w_chunk)
        return w_i, w_i

    _, w = jax.lax.scan(bwd, zero, (l_inv_t, w_bwd, y), reverse=True)
    return jnp.swapaxes(w, 0, 1)


def block_banded_schur(
    d: jax.Array, e: jax.Array, n_schur: int, shift: float = 0.0
):
    """Exact Schur complement of a batched block-banded SPD matrix onto its
    TRAILING n_schur rows (n_schur ≤ bs — the Schur rows live in the last
    block; callers order them last, the reference's
    permuteSchurComplementToBottom contract, preAlps_utils.c:1048).

    This is the batched partial factorization with Schur output —
    the role MKL-PARDISO's iparm[35]=2 and MUMPS' listvar_schur play for
    PRESC (reference: mkl_pardiso_solver.c:131-141, mumps_solver.c:83-90,
    presc.c:239-241). Eliminating the leading blocks of a block-tridiagonal
    matrix only corrects the first trailing diagonal block, so the recursion
    is the standard factor scan stopped one block early + one dense Schur on
    the last block.

    Returns (schur, failed): schur (P, n_schur, n_schur) dense, symmetric.
    """
    P, nblk, bs, _ = d.shape
    if not (0 < n_schur <= bs):
        raise ValueError(f"n_schur must be in (0, {bs}], got {n_schur}")
    dtype = d.dtype
    diag = jnp.einsum("pnii->pni", d)
    d = d + jnp.asarray(shift, dtype) * jax.vmap(jax.vmap(jnp.diag))(diag)
    eye = jnp.broadcast_to(jnp.eye(bs, dtype=dtype), (P, bs, bs))

    def step(carry, de):
        l_inv_prev, bad_prev = carry
        d_i, e_i = de
        m_i = jnp.einsum("pij,pkj->pik", e_i, l_inv_prev, precision=HIGHEST)
        s_i = d_i - jnp.einsum("pik,pjk->pij", m_i, m_i, precision=HIGHEST)
        l_i = jax.lax.linalg.cholesky(s_i, symmetrize_input=True)
        bad = bad_prev | jnp.any(jnp.isnan(l_i))
        l_i = jnp.where(jnp.isnan(l_i), jnp.zeros_like(l_i), l_i)
        l_inv = jax.lax.linalg.triangular_solve(
            l_i, eye, left_side=True, lower=True
        )
        return (l_inv, bad), None

    d_t = jnp.swapaxes(d, 0, 1)
    e_t = jnp.swapaxes(e, 0, 1)
    if nblk > 1:
        (l_inv_prev, bad), _ = jax.lax.scan(
            step, (jnp.zeros_like(eye), jnp.bool_(False)),
            (d_t[:-1], e_t[:-1]),
        )
        m_last = jnp.einsum(
            "pij,pkj->pik", e_t[-1], l_inv_prev, precision=HIGHEST
        )
        d_last = d_t[-1] - jnp.einsum(
            "pik,pjk->pij", m_last, m_last, precision=HIGHEST
        )
    else:
        d_last = d_t[-1]
        bad = jnp.bool_(False)

    # dense Schur of the corrected last block onto its trailing n_schur rows
    k = bs - n_schur
    if k == 0:
        schur = d_last
    else:
        a11 = d_last[:, :k, :k]
        a21 = d_last[:, k:, :k]
        a22 = d_last[:, k:, k:]
        l11 = jax.lax.linalg.cholesky(a11, symmetrize_input=True)
        bad = bad | jnp.any(jnp.isnan(l11))
        l11 = jnp.where(jnp.isnan(l11), jnp.zeros_like(l11), l11)
        w = jax.lax.linalg.triangular_solve(
            l11, jnp.swapaxes(a21, -1, -2), left_side=True, lower=True
        )  # (P, k, n_schur) = L11⁻¹ A12
        schur = a22 - jnp.einsum("pki,pkj->pij", w, w, precision=HIGHEST)
    schur = 0.5 * (schur + jnp.swapaxes(schur, -1, -2))
    return schur, bad
