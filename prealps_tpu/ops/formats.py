"""Device sparse-matrix formats with static shapes.

XLA needs static shapes and regular access; CSR's ragged rows are hostile
to both. Two formats are provided, converted host-side from scipy CSR
(replacing the reference's 4-array MKL CSR, reference:
utils/cplm_light/cplm_kernels.c:620 CPLM_MatCSRKernelGenMatDenseMult):

* ELL: every row padded to the max row length L. vals (n, L), cols (n, L).
  Padding entries have val=0, col=0. Simple, gather-based; the XLA fallback
  path and the CPU test path.

* Block-ELL: rows grouped into bm-row blocks; for each row block, the set of
  bk-wide column blocks containing nonzeros, padded to the max count S.
  blocks (nrb, S, bm, bk), blkcols (nrb, S). This is the dense-block format
  the Pallas SpMM kernel consumes: each (bm, bk) value block multiplies a
  (bk, t) panel slice of X.

Both are registered as pytrees so operators can be closed over in jit.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_pytree_node_class
@dataclass
class EllMatrix:
    vals: jax.Array  # (n, L)
    cols: jax.Array  # (n, L) int32
    shape: tuple     # (n, ncols)

    def tree_flatten(self):
        return (self.vals, self.cols), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    @property
    def nnz_capacity(self):
        return self.vals.shape[0] * self.vals.shape[1]


@jax.tree_util.register_pytree_node_class
@dataclass
class BlockEllMatrix:
    blocks: jax.Array   # (nrb, S, bm, bk)
    blkcols: jax.Array  # (nrb, S) int32; padding slots point at block 0 with zero values
    shape: tuple        # (n, ncols) — multiples of bm / bk respectively

    def tree_flatten(self):
        return (self.blocks, self.blkcols), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    @property
    def bm(self):
        return self.blocks.shape[2]

    @property
    def bk(self):
        return self.blocks.shape[3]

    @property
    def fill_ratio(self):
        """Stored slots / useful nnz — the padding overhead of the format."""
        nnz = np.count_nonzero(np.asarray(self.blocks))
        return self.blocks.size / max(nnz, 1)


def csr_to_ell(a: sp.spmatrix, ncols: int | None = None, dtype=None) -> EllMatrix:
    """Convert CSR to ELL with row padding to the max row length."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    ncols = ncols if ncols is not None else a.shape[1]
    row_len = np.diff(a.indptr)
    ell_width = max(int(row_len.max()), 1)
    vals = np.zeros((n, ell_width), dtype=dtype or a.dtype)
    cols = np.zeros((n, ell_width), dtype=np.int32)
    # scatter each row's entries into its padded slots
    rows = np.repeat(np.arange(n), row_len)
    slot = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_len)
    vals[rows, slot] = a.data
    cols[rows, slot] = a.indices
    return EllMatrix(jnp.asarray(vals), jnp.asarray(cols), (n, ncols))


def rounding_remainder(a: sp.spmatrix, stored,
                       store_dtype=np.float32) -> jax.Array:
    """f32 values of A_lo = A − store(A), laid out like the operator the
    solve keeps: the lane-major (S, br, br, nrb) block table for a stencil
    format (StencilBsrMatrix or StencilBsrTMatrix), the (n, L) values for an
    EllMatrix built from the same `a`. store() is the dtype A is kept in
    (f32, or bfloat16 through ml_dtypes).

    Refinement residuals add A_lo·x so that they see the f64 matrix: without
    it the refinement converges to the stored operator's solution, whose
    true residual sits at ~eps·‖A‖·‖x‖/‖b‖. A_lo itself is f32, not the
    store dtype: a bf16 A_lo's own rounding would set a ~1e-8 floor."""
    def remainder(v64):
        return (v64 - v64.astype(store_dtype).astype(np.float64)
                ).astype(np.float32)

    if isinstance(stored, EllMatrix):
        return jnp.asarray(remainder(np.asarray(
            csr_to_ell(a, dtype=np.float64).vals)))
    # stencil: per-entry lo, then one f32 scatter into the block table
    # (positions are unique), never a dense f64 table
    coo = sp.csr_matrix(a).tocoo()
    lo_vals = remainder(coo.data.astype(np.float64))
    br = stored.br
    nrb = a.shape[0] // br
    offs = np.asarray(stored.offsets)
    slot = np.searchsorted(offs, (coo.col // br) - (coo.row // br))
    lo = np.zeros((offs.size, br, br, nrb), dtype=np.float32)
    lo[slot, coo.row % br, coo.col % br, coo.row // br] = lo_vals
    return jnp.asarray(lo)


def csr_to_block_ell(
    a: sp.spmatrix, bm: int = 8, bk: int = 128, ncols: int | None = None, dtype=None
) -> BlockEllMatrix:
    """Convert CSR to block-ELL; pads n to a multiple of bm and the column
    dimension to a multiple of bk."""
    a = sp.csr_matrix(a)
    n, m = a.shape
    ncols = ncols if ncols is not None else m
    n_pad = -(-n // bm) * bm
    ncols_pad = -(-ncols // bk) * bk
    nrb = n_pad // bm

    coo = a.tocoo()
    rb = coo.row // bm
    cb = coo.col // bk
    # unique (row-block, col-block) pairs, in order
    pair_key = rb.astype(np.int64) * (ncols_pad // bk) + cb
    order = np.argsort(pair_key, kind="stable")
    keys_sorted = pair_key[order]
    uniq_keys, first_idx = np.unique(keys_sorted, return_index=True)
    # slot index of each pair within its row block
    uniq_rb = (uniq_keys // (ncols_pad // bk)).astype(np.int64)
    uniq_cb = (uniq_keys % (ncols_pad // bk)).astype(np.int64)
    counts_per_rb = np.bincount(uniq_rb, minlength=nrb)
    s_max = max(int(counts_per_rb.max() if counts_per_rb.size else 0), 1)
    slot_of_uniq = np.arange(uniq_keys.size) - np.concatenate(
        [[0], np.cumsum(counts_per_rb)]
    )[uniq_rb]

    blocks = np.zeros((nrb, s_max, bm, bk), dtype=dtype or a.dtype)
    blkcols = np.zeros((nrb, s_max), dtype=np.int32)
    blkcols[uniq_rb, slot_of_uniq] = uniq_cb

    # map every nnz to (rb, slot, local_row, local_col)
    key_to_slot_idx = np.searchsorted(uniq_keys, pair_key)
    slot = slot_of_uniq[key_to_slot_idx]
    blocks[rb, slot, coo.row % bm, coo.col % bk] = coo.data

    return BlockEllMatrix(jnp.asarray(blocks), jnp.asarray(blkcols), (n_pad, ncols_pad))


@jax.tree_util.register_pytree_node_class
@dataclass
class StencilBsrMatrix:
    """Stencil block-sparse format for structured-grid FEM/FD operators.

    Rows are grouped into br-sized dof blocks (br = dofs per node, e.g. 3 for
    3-D elasticity, 1 for scalar Poisson). When every nonzero block lies at a
    node offset from a small constant set O (true for lexicographically
    ordered box-grid discretisations — the reference's elasticity3d/Ela400
    benchmark family), the matrix is stored as dense (nrb, |O|, br, br)
    blocks with per-slot SHIFTS instead of gathered columns:

        y₍ᵣ₎ = Σ_s B[r, s] · x₍ᵣ₊ₒ[ₛ]₎

    SpMM then reads each operand exactly once from HBM — no gather, fill
    ratio ≈ 1 (boundary blocks are zero). This is the speed-of-light format
    for the reference's own benchmark matrices; irregular matrices fall back
    to BlockEllMatrix / EllMatrix.
    """

    blocks: jax.Array    # (nrb, S, br, br)
    offsets: tuple       # static tuple of S node offsets (python ints)
    shape: tuple         # (n, n) with n = nrb*br

    def tree_flatten(self):
        return (self.blocks,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @property
    def br(self):
        return self.blocks.shape[2]

    @property
    def fill_ratio(self):
        nnz = np.count_nonzero(np.asarray(self.blocks))
        return self.blocks.size / max(nnz, 1)


def csr_to_stencil_bsr(
    a: sp.spmatrix, br: int, max_offsets: int = 64, dtype=None
) -> StencilBsrMatrix | None:
    """Convert to stencil-BSR if the block pattern is a (small) constant
    stencil; returns None otherwise. Requires br | a.shape[0]."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    if n % br or a.shape[1] != n:
        return None
    nrb = n // br
    coo = a.tocoo()
    rb = coo.row // br
    cb = coo.col // br
    delta = cb - rb
    offs = np.unique(delta)
    if offs.size > max_offsets:
        return None
    s_max = offs.size
    slot_of = {int(d): i for i, d in enumerate(offs)}
    slot = np.searchsorted(offs, delta)
    blocks = np.zeros((nrb, s_max, br, br), dtype=dtype or a.dtype)
    blocks[rb, slot, coo.row % br, coo.col % br] = coo.data
    return StencilBsrMatrix(
        blocks=jnp.asarray(blocks),
        offsets=tuple(int(d) for d in offs),
        shape=(n, n),
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class StencilBsrTMatrix:
    """Lane-major (transposed) stencil format: blocks_t[s, m, k, r] over node
    index r in the MINOR (lane) dimension.

    Keeping the long node axis minor makes every load of the stencil SpMM
    contiguous along nodes, whatever t is. SpMM works on x viewed as
    (t, br, nrb) and unrolls the br×br block product into br² broadcast
    FMAs per stencil offset.
    """

    blocks_t: jax.Array  # (S, br, br, nrb)
    offsets: tuple       # static S node offsets
    shape: tuple         # (n, n), n = nrb*br

    def tree_flatten(self):
        return (self.blocks_t,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @property
    def br(self):
        return self.blocks_t.shape[1]


def csr_to_stencil_bsr_t(
    a: sp.spmatrix, br: int, max_offsets: int = 64, dtype=None
) -> StencilBsrTMatrix | None:
    """Lane-major variant of csr_to_stencil_bsr."""
    base = csr_to_stencil_bsr(a, br=br, max_offsets=max_offsets, dtype=dtype)
    if base is None:
        return None
    blocks_t = jnp.transpose(base.blocks, (1, 2, 3, 0))  # (S, br, br, nrb)
    return StencilBsrTMatrix(blocks_t=blocks_t, offsets=base.offsets, shape=base.shape)


@jax.tree_util.register_pytree_node_class
@dataclass
class DiaEllMatrix:
    """Hybrid DIA + ELL: dense diagonals as static shifted reads, stragglers
    in a small ELL remainder.

    The general-matrix answer to CSR SpMM (reference:
    utils/cplm_light/cplm_kernels.c:620 mkl_dcsrmm): after a bandwidth-
    reducing ordering (RCM), FEM/graph matrices concentrate their nnz on a
    few hundred dense-ish diagonals. Each selected diagonal becomes ONE
    broadcast-multiply of a statically shifted x view — no gathers, full
    lane utilisation — and only the off-band stragglers pay the (slow)
    gather-ELL path. Selection is by per-diagonal occupancy, so the format
    degrades gracefully: a pure band runs gather-free, a random matrix
    falls back to pure ELL.

    y[i] = Σ_d diags[d, i] · x[i + offsets[d]]  +  ELL remainder.
    """

    offsets: tuple          # static diagonal offsets (col − row)
    diags: jax.Array        # (D, n); entry [d, i] multiplies x[i + off_d]
    rem: "EllMatrix | None" # straggler entries (None if band-complete)
    shape: tuple

    def tree_flatten(self):
        return (self.diags, self.rem), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], children[0], children[1], aux[1])

    @property
    def nnz_capacity(self):
        cap = self.diags.shape[0] * self.diags.shape[1]
        return cap + (self.rem.nnz_capacity if self.rem is not None else 0)


def csr_to_dia_ell(
    a: sp.spmatrix,
    min_fill: float = 0.2,
    max_diags: int = 512,
    dtype=None,
) -> DiaEllMatrix:
    """Convert a SQUARE CSR matrix to hybrid DIA+ELL.

    Diagonals holding at least `min_fill · n` nonzeros are promoted to DIA
    (at most `max_diags` of them, densest first); everything else lands in
    the ELL remainder.
    """
    a = sp.csr_matrix(a)
    n, m = a.shape
    if n != m:
        raise ValueError("DIA+ELL requires a square matrix")
    dtype = np.dtype(dtype) if dtype is not None else a.dtype
    coo = a.tocoo()
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq, counts = np.unique(off, return_counts=True)
    dense = uniq[counts >= max(int(min_fill * n), 1)]
    if dense.size > max_diags:
        order = np.argsort(counts[np.isin(uniq, dense)])[::-1]
        dense = np.sort(dense[order[:max_diags]])
    on_dia = np.isin(off, dense)
    diags = np.zeros((max(dense.size, 1), n), dtype=dtype)
    pos = {int(o): d for d, o in enumerate(dense)}
    if dense.size:
        didx = np.fromiter((pos[int(o)] for o in off[on_dia]), dtype=np.int64,
                           count=int(on_dia.sum()))
        np.add.at(diags, (didx, coo.row[on_dia]), coo.data[on_dia])

    rem_mask = ~on_dia
    if rem_mask.any():
        rem_coo = sp.coo_matrix(
            (coo.data[rem_mask], (coo.row[rem_mask], coo.col[rem_mask])),
            shape=a.shape,
        )
        rem = csr_to_ell(sp.csr_matrix(rem_coo), dtype=dtype)
    else:
        rem = None
    offsets = tuple(int(o) for o in dense) if dense.size else (0,)
    return DiaEllMatrix(
        offsets=offsets, diags=jnp.asarray(diags), rem=rem, shape=(n, m)
    )


def dia_coverage(a: sp.spmatrix, min_fill: float = 0.2) -> float:
    """Fraction of nnz on diagonals that would be promoted at `min_fill`."""
    a = sp.csr_matrix(a)
    coo = a.tocoo()
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    _, counts = np.unique(off, return_counts=True)
    dense = counts >= max(int(min_fill * a.shape[0]), 1)
    return float(counts[dense].sum() / max(a.nnz, 1))


def block_fill(a: sp.spmatrix, bm: int = 8, bk: int = 8) -> float:
    """nnz density of the occupied bm×bk blocks (1.0 = perfectly dense)."""
    coo = sp.csr_matrix(a).tocoo()
    if coo.nnz == 0:
        return 0.0
    ncb = -(-a.shape[1] // bk)
    keys = (coo.row // bm).astype(np.int64) * ncb + coo.col // bk
    nblk = np.unique(keys).size
    return float(coo.nnz / (nblk * bm * bk))


def detect_format(
    a: sp.spmatrix,
    br: int = 3,
    nshards: int = 1,
    dia_min_cov: float = 0.85,
    bell_min_fill: float = 0.06,
    allow_stencil: bool = True,
    allow_reorder: bool = True,
) -> tuple[str, dict]:
    """Pick the storage format for `a` (the product path for the
    reference's "any CSR at memory speed" role, mkl_dcsrmm,
    utils/cplm_light/cplm_kernels.c:620-671 — one format does not fit all,
    so structure extraction IS the product path).

    Cascade, fewest bytes and gathers first:
      1. stencil-BSR: constant node-offset stencil pattern (no gathers);
      2. DIA+ELL: ≥ dia_min_cov of nnz on promoted diagonals (tried in
         caller order AND under RCM);
      3. Morton-clustered block-ELL: geometric/mesh graphs without grid
         order — BFS-landmark pseudo-coordinates + Morton order make 8×8
         blocks dense enough that ONE gather index fetches a whole (8, t)
         X-block: a 64·fill reduction in gather indices against a 1/fill
         compute inflation; below fill≈0.10 it stops paying;
      4. ELL (gather-bound floor): anything else.

    allow_reorder=False disables the choices that require a row
    permutation (Morton clustering, RCM-recovered DIA) — e.g. when the
    caller pins the row partition.

    Returns (fmt, info): fmt in {"stencil", "dia", "dia_rcm",
    "block_ell_morton", "block_ell_natural", "ell"}; info carries the
    scores and, for the reordering choices, the permutation under
    info["perm"].
    """
    a = sp.csr_matrix(a)
    n, m = a.shape
    info: dict = {}

    # 1. stencil candidate: few unique node offsets + dense-enough blocks
    st_fill = 0.0
    stencil_ok = False
    if allow_stencil and n == m and n % br == 0:
        coo = a.tocoo()
        delta = coo.col.astype(np.int64) // br - coo.row.astype(np.int64) // br
        offs = np.unique(delta)
        info["stencil_offsets"] = int(offs.size)
        if offs.size <= 64:
            st_fill = a.nnz / ((n // br) * offs.size * br * br)
            info["stencil_fill"] = round(float(st_fill), 3)
            stencil_ok = st_fill >= 0.1

    # 2. diagonal coverage in caller order
    cov = dia_coverage(a, min_fill=0.05)
    info["dia_coverage"] = round(float(cov), 3)

    # stencil-vs-dia arbitration: a SCALAR-banded matrix also passes the
    # br-block stencil test but at ~1/br block fill — the br=1 DIA form
    # moves 1/fill fewer bytes (measured 2.6× on the 17-diagonal class).
    # DIA only wins the arbitration when it actually QUALIFIES (≥ the
    # caller's dia_min_cov too), else the passing stencil stands.
    prefer_dia = cov >= max(0.9, dia_min_cov) and st_fill < 0.5
    if stencil_ok and not prefer_dia:
        return "stencil", info
    if cov >= dia_min_cov:
        return "dia", info
    if stencil_ok:
        return "stencil", info
    if n == m and allow_reorder:
        from prealps_tpu.core.partition import rcm_order

        perm_r = rcm_order(a)
        ap_r = a[perm_r][:, perm_r].tocsr()
        cov_r = dia_coverage(ap_r, min_fill=0.05)
        info["dia_coverage_rcm"] = round(float(cov_r), 3)
        if cov_r >= dia_min_cov:
            info["perm"] = perm_r
            info["permuted"] = ap_r   # already built for scoring — reuse
            return "dia_rcm", info

    # 3. Morton-clustered block-ELL vs plain ELL. Multi-shard block-ELL
    # exchanges 128-wide column blocks — the fill threshold is unreachable
    # there, so skip the (5-BFS-sweep) Morton probe entirely.
    bk = 8 if nshards <= 1 else 128
    fill_nat = block_fill(a, 8, bk)
    info["bell_fill_natural"] = round(fill_nat, 3)
    if n == m and nshards <= 1 and allow_reorder:
        from prealps_tpu.core.partition import morton_perm, pseudo_coords

        perm = morton_perm(pseudo_coords(a))
        ap = a[perm][:, perm].tocsr()
        fill_m = block_fill(ap, 8, bk)
        info["bell_fill_morton"] = round(fill_m, 3)
        # measured: Morton block-ELL beats ELL 1.56× at fill 0.084 and
        # 1.9× at ~0.15; below ~0.06 the 1/fill compute inflation wins
        if fill_m >= bell_min_fill and fill_m > 1.3 * fill_nat:
            info["perm"] = perm
            info["permuted"] = ap     # already built for scoring — reuse
            return "block_ell_morton", info
    if fill_nat >= max(bell_min_fill, 0.1):
        return "block_ell_natural", info

    # 4. gather-bound floor
    return "ell", info


def csr_to_dia_ell_auto(
    a: sp.spmatrix, min_fill: float = 0.2, dtype=None
):
    """Hybrid DIA+ELL with automatic ordering: keeps the CALLER's order when
    it is already diagonal-dominated, else tries RCM and keeps whichever
    covers more nnz on promoted diagonals.

    Grid operators in natural order are ~100% diagonal-covered (measured:
    99 diagonals cover ALL of 36³ elasticity at 1.2× the stencil format's
    traffic), while RCM smears them across thousands of sparse diagonals —
    bandwidth reduction is the right move for banded SOLVERS, not for
    diagonal-structured PRODUCTS.

    Returns (DiaEllMatrix, perm) with perm=None when the caller's order won
    (the operator then applies to unpermuted vectors).
    """
    from prealps_tpu.core.partition import rcm_order

    cov_nat = dia_coverage(a, min_fill)
    if cov_nat >= 0.9:
        return csr_to_dia_ell(a, min_fill=min_fill, dtype=dtype), None
    perm = rcm_order(sp.csr_matrix(a))
    ap = sp.csr_matrix(sp.csr_matrix(a)[perm][:, perm])
    cov_rcm = dia_coverage(ap, min_fill)
    if cov_rcm > cov_nat:
        return csr_to_dia_ell(ap, min_fill=min_fill, dtype=dtype), perm
    return csr_to_dia_ell(a, min_fill=min_fill, dtype=dtype), None
