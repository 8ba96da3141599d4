"""spMSV: sparse matrix × sparse multivector product with structure tracking.

(reference: utils/iterativeKernels/spMSV.c preAlps_spMSV — C = A·B where B is
a sparse block multivector; the routine tracks the (a_nparts × b_nparts)
block structure of B and C, skips empty blocks, and switches C to dense when
it fills in; used for s-step/CA Krylov basis construction, not called by ECG
— iterativeKernels/README.md:3.)

Redesign: values are carried DENSE (n, t) — dense panels are the profitable
regime for batched products and XLA needs static shapes — while the BLOCK
STRUCTURE is tracked exactly like the reference's ABlockStruct contract
(spMSV.h:57-60):

* `block_support_graph` = the user-precomputed ABlockStruct;
* `spmsv` takes B's (row-block × col-block) support, masks the dead blocks,
  multiplies, and returns C plus its PREDICTED support
  struct(C) = struct(A) · struct(B) (boolean product) and the
  reference's sparse→dense switch decision as a fill-ratio flag
  (spMSV.h options[2] / return code 1);
* across s-step basis builds the support fronts grow by one block
  neighborhood per application (`propagate_support`), so callers know when
  masking stops paying off — the same economics as the reference's dynamic
  reallocation, decided statically.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp


def block_support_graph(a: sp.spmatrix, offsets: np.ndarray) -> sp.csr_matrix:
    """Block connectivity graph: G[i, j] = 1 iff block row i of A has a
    nonzero in block column j (blocks given by `offsets`) — the
    ABlockStruct the reference requires precomputed (spMSV.h:57-60)."""
    a = sp.csr_matrix(a)
    nb = len(offsets) - 1
    coo = a.tocoo()
    rb = np.searchsorted(offsets, coo.row, side="right") - 1
    cb = np.searchsorted(offsets, coo.col, side="right") - 1
    g = sp.coo_matrix((np.ones_like(rb), (rb, cb)), shape=(nb, nb))
    g = (g.tocsr() > 0).astype(np.int8)
    return g


def propagate_support(g: sp.csr_matrix, support: np.ndarray, steps: int = 1) -> np.ndarray:
    """Support after `steps` applications: struct(G^steps · support).

    support: (nb,) or (nb, k) boolean; returns the same shape."""
    s = support.astype(np.int8)
    for _ in range(steps):
        s = np.asarray((g @ s) > 0, dtype=np.int8)
    return s.astype(bool)


def spmsv(
    a_apply,
    b: jax.Array,
    b_struct: np.ndarray,
    a_block_struct: sp.spmatrix,
    row_offsets: np.ndarray,
    col_offsets: np.ndarray | None = None,
    dense_switch: float = 0.5,
):
    """C = A·B for a block-sparse multivector B with structure tracking.

    b: (n, t) dense carrier. b_struct: host boolean, either (nbr,) — one
    support flag per block row, all columns alike — or (nbr, nbc) with
    col_offsets giving B's column blocks (the reference's b_ncolparts,
    spMSV.h:53-55). a_block_struct: block graph of A (block_support_graph).

    Returns (c, c_struct, is_dense):
      c        = A · (B restricted to its support), (n, t);
      c_struct = predicted support of C (same shape class as b_struct) —
                 struct(A)·struct(B), exact for generic values;
      is_dense = True when c_struct's fill ratio ≥ dense_switch — the
                 reference's sparse→dense switch (spMSV.h return code 1);
                 callers should stop masking from then on.
    """
    n, t = b.shape
    b_struct = np.asarray(b_struct)
    row_sizes = jnp.asarray(np.diff(row_offsets))

    if b_struct.ndim == 1:
        row_mask = jnp.repeat(
            jnp.asarray(b_struct.astype(b.dtype)), row_sizes,
            total_repeat_length=n,
        )
        mask = row_mask[:, None]
    else:
        assert col_offsets is not None, "2-D b_struct needs col_offsets"
        col_sizes = jnp.asarray(np.diff(col_offsets))
        mask = jnp.repeat(
            jnp.asarray(b_struct.astype(b.dtype)), row_sizes, axis=0,
            total_repeat_length=n,
        )
        mask = jnp.repeat(mask, col_sizes, axis=1, total_repeat_length=t)

    c = a_apply(b * mask)
    c_struct = propagate_support(sp.csr_matrix(a_block_struct), b_struct)
    is_dense = bool(np.mean(c_struct) >= dense_switch)
    return c, c_struct, is_dense


def spmsv_chain(
    a_apply,
    b: jax.Array,
    b_struct: np.ndarray,
    a_block_struct: sp.spmatrix,
    row_offsets: np.ndarray,
    steps: int,
    col_offsets: np.ndarray | None = None,
    dense_switch: float = 0.5,
):
    """s-step basis build: [B, AB, A²B, …] with structure tracking; masking
    is dropped once the support fills in (the dense regime). Returns
    (panels list, structs list)."""
    panels, structs = [b], [np.asarray(b_struct)]
    cur, cur_struct = b, np.asarray(b_struct)
    dense = False
    for _ in range(steps):
        if dense:
            cur = a_apply(cur)
            cur_struct = np.ones_like(cur_struct)
        else:
            cur, cur_struct, dense = spmsv(
                a_apply, cur, cur_struct, a_block_struct, row_offsets,
                col_offsets, dense_switch,
            )
        panels.append(cur)
        structs.append(cur_struct)
    return panels, structs


# ---------------------------------------------------------------------------
# Sparse-VALUED spMSV (round 3): packed active blocks, static capacity
# ---------------------------------------------------------------------------
#
# The dense-carrier spmsv above masks dead blocks but still stores and
# multiplies (n, t) values — it tracks the reference's structure contract
# with nothing sparse to switch FROM. The packed variant
# stores ONLY the active row-blocks of B ((cap, bs, t) + block ids) and
# computes ONLY the active row-blocks of C: traffic and FLOPs scale with
# the active fraction, exactly the economics of the reference's
# preAlps_spMSV (spMSV.h:16-86). Static shapes shape the design: the
# active set lives in a CAPACITY-padded buffer (static shapes; -1 = dead
# slot), A rides the block-ELL format at block granularity, and the
# sparse->dense switch compares the PREDICTED fill against the threshold
# host-side (support prediction is host metadata here, as the reference
# requires the block struct precomputed).


def pack_multivector(b: jax.Array, bs: int, ids: np.ndarray, cap: int):
    """(n, t) dense -> (ids (cap,), vals (cap, bs, t)) active row-blocks.

    ids: host int array of active block rows (sorted, unique), len ≤ cap.
    """
    n, t = b.shape
    ids_pad = np.full(cap, -1, dtype=np.int32)
    ids_pad[: len(ids)] = np.asarray(ids, dtype=np.int32)
    bb = b.reshape(n // bs, bs, t)
    gather = jnp.asarray(np.where(ids_pad >= 0, ids_pad, 0))
    vals = bb[gather] * (jnp.asarray(ids_pad) >= 0)[:, None, None].astype(b.dtype)
    return jnp.asarray(ids_pad), vals


def unpack_multivector(ids: jax.Array, vals: jax.Array, nb: int) -> jax.Array:
    """Packed blocks -> dense (nb*bs, t) (dead slots ignored)."""
    cap, bs, t = vals.shape
    out = jnp.zeros((nb + 1, bs, t), vals.dtype)
    idx = jnp.where(ids >= 0, ids, nb)
    out = out.at[idx].add(vals)
    return out[:nb].reshape(nb * bs, t)


def spmsv_packed(ab, b_ids: jax.Array, b_vals: jax.Array,
                 c_ids: np.ndarray, cap_c: int):
    """Packed C = A·B on active blocks only.

    ab: BlockEllMatrix with bm == bk == bs (csr_to_block_ell);
    b_ids/b_vals: packed B (pack_multivector);
    c_ids: host prediction of C's active block rows (propagate_support of
    B's support through the block graph — generically exact);
    returns (c_ids_dev (cap_c,), c_vals (cap_c, bs, t)).

    FLOPs = cap_c · S · bs² · t (vs nb · S · bs² · t dense): the saving is
    the active fraction. One gather of A's active block rows + one gather
    of B's referenced blocks; everything else is one batched einsum.
    """
    nrb, s_max, bs, bs2 = ab.blocks.shape
    assert bs == bs2, "spmsv_packed needs square blocks (bm == bk)"
    cap_b = b_vals.shape[0]
    t = b_vals.shape[2]

    c_ids_pad = np.full(cap_c, -1, dtype=np.int32)
    c_ids_pad[: len(c_ids)] = np.asarray(c_ids, dtype=np.int32)
    c_ids_d = jnp.asarray(c_ids_pad)
    c_gather = jnp.where(c_ids_d >= 0, c_ids_d, 0)

    # slot of each block column in B's packed buffer; dead -> cap_b (zero)
    posmap = jnp.full((nrb + 1,), cap_b, dtype=jnp.int32)
    posmap = posmap.at[jnp.where(b_ids >= 0, b_ids, nrb)].set(
        jnp.arange(cap_b, dtype=jnp.int32))
    posmap = posmap.at[nrb].set(cap_b)

    blk = ab.blocks[c_gather]                  # (cap_c, S, bs, bs)
    cols = ab.blkcols[c_gather]                # (cap_c, S)
    pos = posmap[jnp.minimum(cols, nrb)]       # (cap_c, S)
    b_ext = jnp.concatenate(
        [b_vals, jnp.zeros((1, bs, t), b_vals.dtype)], axis=0)
    gathered = b_ext[pos]                      # (cap_c, S, bs, t)
    c_vals = jnp.einsum(
        "csmk,cskt->cmt", blk, gathered,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=b_vals.dtype,
    )
    c_vals = c_vals * (c_ids_d >= 0)[:, None, None].astype(c_vals.dtype)
    return c_ids_d, c_vals


def predict_c_support(g: sp.csr_matrix, b_ids, nb: int) -> np.ndarray:
    """Active C block rows = struct(G) · support(B) (host metadata)."""
    s = np.zeros(nb, dtype=np.int8)
    ids = np.asarray(b_ids)
    s[ids[ids >= 0]] = 1
    return np.flatnonzero(np.asarray((g @ s) > 0))
