"""Row layouts: how a global sparse operator maps onto a device mesh.

Replaces the reference's distributed-operator bookkeeping (reference:
utils/operator.c rowPos_g/colPos_g/dep_g and utils/cplm_v0/cplm_v0_matcsr.c
GetColBlockPos/GetCommDep): a RowLayout records the partition-derived
permutation, per-shard row ranges (equalised by padding so shard_map sees
static shapes), and the block-column dependency sets used for halo exchange.

Difference vs the reference: ranks own *equal-size padded* row
panels (static shapes for XLA) instead of exact METIS part sizes; the padded
tail rows carry an identity diagonal so the operator stays SPD and the
padded solution entries are exactly zero.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from prealps_tpu.core.partition import kway_partition, partition_to_perm


@dataclass(frozen=True)
class RowLayout:
    """Static description of a 1-D row partition over `nshards` devices."""

    n: int                     # original global size
    n_pad: int                 # padded global size (= nshards * rows_per_shard)
    nshards: int
    rows_per_shard: int
    perm: np.ndarray           # padded position -> old row index; -1 on padding (length n_pad)
    inv_perm: np.ndarray       # old row index -> padded position (length n)
    offsets: np.ndarray        # unpadded partition offsets within permuted order, length nshards+1
    # deps[s] = sorted array of shards whose rows shard s needs for SpMM
    deps: tuple = field(default=(), compare=False)

    def pad_vector(self, x: np.ndarray) -> np.ndarray:
        """Global vector/block in original ordering -> padded permuted order."""
        return pad_to_padded(self, x)

    def unpad_vector(self, xp: np.ndarray) -> np.ndarray:
        """Inverse of pad_vector."""
        return unpad_from_padded(self, xp)

    def shard_rows(self, s: int) -> slice:
        return slice(s * self.rows_per_shard, (s + 1) * self.rows_per_shard)


def _padded_perm_offsets(part: np.ndarray, nshards: int, row_multiple: int = 8):
    """Permutation ordering rows by part, plus equalised per-shard ranges.

    Rows are ordered part-by-part; each shard's panel is then padded at the
    global tail. To keep every shard's *own* rows contiguous AND equal-sized,
    we interleave padding rows per shard: shard s owns permuted-global rows
    [s*rps, (s+1)*rps), the first count[s] of which are real. rows_per_shard
    is rounded up to row_multiple (8 by default) so device block formats
    tile cleanly.
    """
    counts = np.bincount(part, minlength=nshards)
    rows_per_shard = int(counts.max())
    rows_per_shard = -(-rows_per_shard // row_multiple) * row_multiple
    perm_grouped, offsets = partition_to_perm(part, nshards)
    return perm_grouped, offsets, rows_per_shard


def build_row_layout(a: sp.spmatrix, nshards: int, refine_passes: int = 8,
                     row_multiple: int = 8) -> RowLayout:
    """Partition A's rows into nshards balanced parts and build the layout."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    if nshards == 1:
        part = np.zeros(n, dtype=np.int64)
    else:
        part = kway_partition(a, nshards, refine_passes)
    return layout_from_part(a, part, nshards, row_multiple=row_multiple)


def layout_from_part(a: sp.spmatrix, part: np.ndarray, nshards: int,
                     row_multiple: int = 8) -> RowLayout:
    a = sp.csr_matrix(a)
    n = a.shape[0]
    perm_grouped, offsets, rows_per_shard = _padded_perm_offsets(
        part, nshards, row_multiple)
    n_pad = rows_per_shard * nshards

    inv = np.empty(n, dtype=np.int64)
    inv[perm_grouped] = np.arange(n)

    # dependency sets on the *permuted, padded* matrix: shard s depends on
    # shard q if any column of s's rows falls in q's padded range
    ap = a[perm_grouped][:, perm_grouped].tocsr()
    deps = []
    counts = np.diff(offsets)
    for s in range(nshards):
        rows = slice(offsets[s], offsets[s + 1])
        cols = ap.indices[ap.indptr[rows.start]: ap.indptr[rows.stop]]
        owners = np.searchsorted(offsets, cols, side="right") - 1
        deps.append(tuple(sorted(set(int(o) for o in owners) - {s})))

    # remap permuted index -> padded index (shard-local padding at panel tail)
    idx_perm = np.arange(n)
    owner = np.searchsorted(offsets, idx_perm, side="right") - 1
    new_positions = owner * rows_per_shard + (idx_perm - offsets[owner])

    # perm_pad: padded-row -> old row; -1 for padding
    perm_pad = np.full(n_pad, -1, dtype=np.int64)
    perm_pad[new_positions] = perm_grouped
    inv = np.empty(n, dtype=np.int64)
    inv[perm_grouped] = new_positions

    return RowLayout(
        n=n,
        n_pad=n_pad,
        nshards=nshards,
        rows_per_shard=rows_per_shard,
        perm=perm_pad,
        inv_perm=inv,
        offsets=offsets,
        deps=tuple(deps),
    )


def permute_and_pad_matrix(a: sp.spmatrix, layout: RowLayout) -> sp.csr_matrix:
    """Return the (n_pad, n_pad) permuted matrix with identity on padded rows."""
    a = sp.csr_matrix(a)
    coo = a.tocoo()
    rows = layout.inv_perm[coo.row]
    cols = layout.inv_perm[coo.col]
    pad_rows = np.flatnonzero(layout.perm < 0)
    data = np.concatenate([coo.data, np.ones(pad_rows.size, dtype=coo.data.dtype)])
    rows = np.concatenate([rows, pad_rows])
    cols = np.concatenate([cols, pad_rows])
    out = sp.coo_matrix((data, (rows, cols)), shape=(layout.n_pad, layout.n_pad)).tocsr()
    out.sort_indices()
    return out


def real_row_mask(layout: RowLayout) -> np.ndarray:
    """Boolean mask over padded rows: True where the row is a real dof."""
    return layout.perm >= 0


def pad_to_padded(layout: RowLayout, x: np.ndarray) -> np.ndarray:
    """Global vector/block in ORIGINAL ordering -> padded permuted ordering."""
    x = np.asarray(x)
    out = np.zeros((layout.n_pad,) + x.shape[1:], dtype=x.dtype)
    out[layout.inv_perm] = x
    return out


def unpad_from_padded(layout: RowLayout, xp: np.ndarray) -> np.ndarray:
    """Padded permuted vector/block -> original global ordering."""
    return np.asarray(xp)[layout.inv_perm]


def contiguous_row_layout(n: int, nshards: int, row_multiple: int = 8) -> RowLayout:
    """Identity-ordered contiguous row partition with ALL padding at the
    global tail (last shard). Preserves stencil structure (ops/formats.py
    StencilBsrMatrix): no permutation, so neighbor offsets are unchanged.
    The analog of the reference's pre-partitioned path
    (reference: utils/operator.c:271 preAlps_OperatorBuildNoPerm)."""
    rps = -(-n // nshards)
    rps = -(-rps // row_multiple) * row_multiple
    n_pad = rps * nshards
    part = np.minimum(np.arange(n) // rps, nshards - 1).astype(np.int64)
    counts = np.bincount(part, minlength=nshards)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    perm = np.full(n_pad, -1, dtype=np.int64)
    perm[:n] = np.arange(n)
    inv = np.arange(n, dtype=np.int64)
    deps = tuple(
        tuple(q for q in range(nshards) if q != s) for s in range(nshards)
    )
    return RowLayout(
        n=n, n_pad=n_pad, nshards=nshards, rows_per_shard=rps,
        perm=perm, inv_perm=inv, offsets=offsets, deps=deps,
    )


@dataclass(frozen=True)
class HaloPlan:
    """Static neighbor-exchange schedule for the distributed ELL SpMM.

    The analog of the reference's dep-list halo exchange
    (reference: utils/cplm_v0/cplm_v0_matmult_v2.c:14-343 precomputed sub-CSR
    windows + ISend/Irecv; deps from cplm_v0_matcsr.c:234 GetCommDep): each
    shard packs exactly the boundary rows of X its neighbors reference
    (send_idx), one `all_to_all` moves all packs, and the local ELL
    columns are pre-remapped into [own rows ∥ halo buffer] coordinates —
    comm volume ∝ cut edges instead of the full panel.
    """

    h: int                    # rows per (src, dst) slot (max over pairs)
    send_idx: np.ndarray      # (S, S, h) int32: local rows shard s packs for d
    cols_local: np.ndarray    # (n_pad, L) int32: ELL cols in local+halo space
    comm_rows: int            # true (unpadded) total rows exchanged

    @property
    def halo_rows_per_shard(self) -> int:
        return self.send_idx.shape[1] * self.h


def build_halo_plan(
    layout: RowLayout, ell_cols: np.ndarray, ell_vals: np.ndarray
) -> HaloPlan:
    """Derive the exchange schedule from the padded ELL structure.

    ell_cols/ell_vals: (n_pad, L) global padded column ids and values (zero
    values mark padding slots, which are excluded from the dependency scan).
    """
    s_n = layout.nshards
    mpl = layout.rows_per_shard
    n_pad = layout.n_pad
    used = ell_vals != 0
    owner_of = ell_cols // mpl

    needed = [[None] * s_n for _ in range(s_n)]  # needed[s][q] = global cols
    h = 1
    comm_rows = 0
    for s in range(s_n):
        rows = slice(s * mpl, (s + 1) * mpl)
        cols_s = ell_cols[rows][used[rows]]
        own = owner_of[rows][used[rows]]
        for q in range(s_n):
            if q == s:
                continue
            cq = np.unique(cols_s[own == q])
            needed[s][q] = cq
            h = max(h, cq.size)
            comm_rows += cq.size

    send_idx = np.zeros((s_n, s_n, h), dtype=np.int32)
    for q in range(s_n):
        for s in range(s_n):
            if q == s:
                continue
            cq = needed[s][q]
            send_idx[q, s, : cq.size] = (cq - q * mpl).astype(np.int32)

    cols_local = np.zeros_like(ell_cols, dtype=np.int32)
    for s in range(s_n):
        rows = slice(s * mpl, (s + 1) * mpl)
        c = ell_cols[rows]
        o = c // mpl
        out = np.where(o == s, c - s * mpl, 0).astype(np.int64)
        for q in range(s_n):
            if q == s:
                continue
            cq = needed[s][q]
            sel = o == q
            if cq.size and np.any(sel):
                # Padding (zero-value) slots may reference off-shard columns
                # absent from cq; clamp so the remapped index stays inside
                # the gather buffer (value is zero, so result is unaffected).
                pos = np.minimum(np.searchsorted(cq, c[sel]), cq.size - 1)
                out[sel] = mpl + q * h + pos
            elif np.any(sel):  # only padding slots can point off-shard unused
                out[sel] = 0
        cols_local[rows] = out.astype(np.int32)
    return HaloPlan(h=h, send_idx=send_idx, cols_local=cols_local,
                    comm_rows=comm_rows)


@dataclass(frozen=True)
class BlockHaloPlan:
    """Static neighbor-exchange schedule for the distributed block-ELL SpMM.

    Same contract as HaloPlan but at bk-column-block granularity (the
    block-ELL gather unit): each shard packs exactly the bk-row X blocks its
    neighbors reference, one all_to_all moves the packs, and blkcols are
    pre-remapped into [own blocks ∥ halo buffer] block coordinates — comm
    volume ∝ cut column-blocks instead of the full panel (reference:
    utils/cplm_v0/cplm_v0_matmult_v2.c dep-list ISend/Irecv at sub-CSR
    granularity; deps from cplm_v0_matcsr.c:234 GetCommDep).
    """

    hb: int                     # blocks per (src, dst) slot (max over pairs)
    send_idx: np.ndarray        # (S, S, hb) int32: local blocks s packs for d
    blkcols_local: np.ndarray   # (nrb, s_max) int32 in local+halo block space
    comm_blocks: int            # true (unpadded) total blocks exchanged


def build_block_halo_plan(
    layout: RowLayout, blkcols: np.ndarray, blocks: np.ndarray, bk: int
) -> BlockHaloPlan:
    """Derive the block-granular exchange schedule from block-ELL structure.

    blkcols: (nrb, s_max) global bk-column-block ids; blocks: matching value
    blocks (all-zero blocks mark padding slots, excluded from the scan).
    Requires rows_per_shard % bk == 0 so no X block straddles two shards.
    """
    s_n = layout.nshards
    mpl = layout.rows_per_shard
    if mpl % bk:
        raise ValueError(f"rows_per_shard={mpl} not a multiple of bk={bk}")
    nblk_loc = mpl // bk
    nrb_tot, s_max = blkcols.shape
    nrb_loc = nrb_tot // s_n
    used = np.asarray(blocks).reshape(nrb_tot, s_max, -1).any(axis=2)
    owner_of = blkcols // nblk_loc

    needed = [[None] * s_n for _ in range(s_n)]
    hb = 1
    comm_blocks = 0
    for s in range(s_n):
        rows = slice(s * nrb_loc, (s + 1) * nrb_loc)
        cb_s = blkcols[rows][used[rows]]
        own = owner_of[rows][used[rows]]
        for q in range(s_n):
            if q == s:
                continue
            cq = np.unique(cb_s[own == q])
            needed[s][q] = cq
            hb = max(hb, cq.size)
            comm_blocks += cq.size

    send_idx = np.zeros((s_n, s_n, hb), dtype=np.int32)
    for q in range(s_n):
        for s in range(s_n):
            if q == s:
                continue
            cq = needed[s][q]
            send_idx[q, s, : cq.size] = (cq - q * nblk_loc).astype(np.int32)

    blkcols_local = np.zeros_like(blkcols, dtype=np.int32)
    for s in range(s_n):
        rows = slice(s * nrb_loc, (s + 1) * nrb_loc)
        c = blkcols[rows]
        o = c // nblk_loc
        out = np.where(o == s, c - s * nblk_loc, 0).astype(np.int64)
        for q in range(s_n):
            if q == s:
                continue
            cq = needed[s][q]
            sel = o == q
            if cq.size and np.any(sel):
                # Clamp like build_halo_plan: padding slots must stay in-buffer.
                pos = np.minimum(np.searchsorted(cq, c[sel]), cq.size - 1)
                out[sel] = nblk_loc + q * hb + pos
            elif np.any(sel):  # only padding slots can point off-shard unused
                out[sel] = 0
        blkcols_local[rows] = out.astype(np.int32)
    return BlockHaloPlan(hb=hb, send_idx=send_idx,
                         blkcols_local=blkcols_local,
                         comm_blocks=comm_blocks)
