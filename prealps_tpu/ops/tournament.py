"""Tournament pivoting: communication-avoiding column selection, TP-QR, TP-CUR.

(reference: utils/iterativeKernels/tournamentPivoting{,QR,CUR}.c — deliverable
D4.1 kernels; binary reduction tree where each node runs a strong
rank-revealing QR on the candidate columns and passes the k winners up.)

Redesign: the local rank-revealing step is QR with column
pivoting — implemented here as a jittable greedy pivoted CholQR on the
candidate Gram matrix (k steps of diagonal-pivoted Cholesky ≡ column-norm
greedy pivoting, the same selection rule QRCP uses). The tree combine is a
pair-wise union of winners, so log2(P) rounds select k columns from the whole
matrix. Dense panels throughout — the candidate sets are k..2k columns.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from prealps_tpu.ops.blockops import HIGHEST, pivoted_cholesky


def qrcp_select(panel: jax.Array, k: int) -> jax.Array:
    """Indices of k rank-revealing columns of `panel` (m, c), c small.

    Uses diagonal-pivoted Cholesky of the Gram matrix — mathematically the
    same pivot order as Householder QRCP (both greedily maximise the
    residual column norm).

    Numerics: the Gram squares the panel's
    condition number, so naive f32 accumulation loses pivot fidelity past
    cond(panel) ≈ 3e3. Two mitigations, both applied:
    ① a TSQR pass first — the Gram is then formed from the tiny (c, c)
      R factor, so accumulation error grows with c, not m (Householder QR
      per leaf, same stability class as the reference's SuiteSparseQR leaf
      factorizations, tournamentPivoting.c:35-40);
    ② the R-Gram and the pivoted Cholesky run in float64 when x64 is
      enabled (f32 runs keep them usable to cond ≈ 1e4).
    Failure mode (documented, like QRCP itself): greedy column-norm
    pivoting carries no strong-RRQR guarantee — adversarial Kahan-type
    matrices can hide a large trailing singular value from every greedy
    pivot order; the reference's SuiteSparseQR leaf QR has the same
    property. test_tournament_dist.py pins singular-value approximation
    quality against dense SVD on random and graded spectra.
    """
    m, c = panel.shape
    work = panel
    if m > c:
        from prealps_tpu.ops.tsqr import tsqr_r

        work = tsqr_r(panel, nblocks=max(1, min(8, m // max(c, 1))))
    if jax.config.jax_enable_x64:
        work = work.astype(jnp.float64)
    g = jnp.einsum("mc,md->cd", work, work, precision=HIGHEST)
    _, piv, _ = pivoted_cholesky(g, jnp.asarray(-1.0, g.dtype))
    return piv[:k]


def tournament_select(a: jax.Array, k: int, nblocks: int = 8) -> jax.Array:
    """Select k columns of a (m, n) by tournament pivoting. Returns global
    column indices (k,), deterministic."""
    m, n = a.shape
    nblocks = int(min(nblocks, max(1, n // max(k, 1))))
    cb = -(-n // nblocks)
    pad = nblocks * cb - n
    if pad:
        a = jnp.concatenate([a, jnp.zeros((m, pad), a.dtype)], axis=1)
    # leaf round: winners per block
    cols = jnp.arange(nblocks * cb).reshape(nblocks, cb)
    winners = []
    for b in range(nblocks):
        sel = qrcp_select(a[:, b * cb:(b + 1) * cb], min(k, cb))
        winners.append(cols[b, sel])
    winners = [w for w in winners]
    # tree rounds
    while len(winners) > 1:
        nxt = []
        for i in range(0, len(winners) - 1, 2):
            cand = jnp.concatenate([winners[i], winners[i + 1]])
            sel = qrcp_select(a[:, cand], min(k, cand.shape[0]))
            nxt.append(cand[sel])
        if len(winners) % 2 == 1:
            nxt.append(winners[-1])
        winners = nxt
    sel = winners[0][:k]
    return sel


def tp_qr(a: jax.Array, k: int, nblocks: int = 8):
    """Tournament-pivoting QR: A ≈ Q R[:, perm] with k selected columns
    leading. Returns (q, r, cols) where q (m, k), r (k, n), cols (k,).

    (reference: utils/iterativeKernels/tournamentPivotingQR.c)"""
    from prealps_tpu.ops.tsqr import tsqr

    cols = tournament_select(a, k, nblocks)
    q, r_kk = tsqr(a[:, cols], nblocks=nblocks)
    r = jnp.einsum("mk,mn->kn", q, a, precision=HIGHEST)
    return q, r, cols


def tp_cur(a: jax.Array, k: int, nblocks: int = 8):
    """Tournament-pivoting CUR: A ≈ C U R with C = k columns, R = k rows of A.

    (reference: utils/iterativeKernels/tournamentPivotingCUR.c)"""
    cols = tournament_select(a, k, nblocks)
    rows = tournament_select(a.T, k, nblocks)
    c = a[:, cols]
    r = a[rows, :]
    # U = C⁺ A R⁺ via least squares through the selected cross block
    u = jnp.linalg.pinv(c) @ a @ jnp.linalg.pinv(r)
    return c, u, r, cols, rows


# ---------------------------------------------------------------------------
# cross-shard (mesh) tournament — the distributed reduction tree
# ---------------------------------------------------------------------------

def tournament_select_sharded(
    a_loc: jax.Array, axis_name: str, k: int, nblocks: int = 8
) -> jax.Array:
    """Tournament pivoting across a column-sharded matrix inside shard_map.

    a_loc: (m, n_loc) — this shard's column panel. Returns GLOBAL column
    indices (k,), replicated on every shard (columns are numbered
    shard-major: global = shard * n_loc + local).

    The reference's binary reduction tree moves candidate columns up
    log2(P) MPI levels (reference: utils/iterativeKernels/
    tournamentPivoting.c:41-80). On a device mesh the latency-optimal shape is
    ONE fused all_gather of every shard's k winner columns (S·k·m values)
    followed by a replicated final round — collectives are cheap on the
    device interconnect and
    S·k panels are small; a log-depth ppermute chain would serialise
    log2(S) latencies for no volume saving.
    """
    n_loc = a_loc.shape[1]
    k_loc = min(k, n_loc)
    sel_loc = tournament_select(a_loc, k_loc, nblocks)   # (k_loc,) local ids
    panel_loc = a_loc[:, sel_loc]                        # (m, k_loc)
    panels = jax.lax.all_gather(panel_loc, axis_name, axis=1, tiled=True)
    sels = jax.lax.all_gather(sel_loc, axis_name, axis=0, tiled=False)
    win = qrcp_select(panels, k)                         # among S*k_loc
    shard = win // k_loc
    within = win % k_loc
    return shard * n_loc + sels[shard, within]


def tp_qr_sharded(a_loc: jax.Array, axis_name: str, k: int, nblocks: int = 8):
    """Distributed TP-QR of a column-sharded matrix.

    Returns (q, r_loc, cols): q (m, k) replicated orthonormal basis of the
    k tournament-selected columns, r_loc = qᵀ a_loc (k, n_loc) sharded like
    the input, cols (k,) global indices (replicated).
    (reference: utils/iterativeKernels/tournamentPivotingQR.c)"""
    from prealps_tpu.ops.tsqr import tsqr

    n_loc = a_loc.shape[1]
    k_loc = min(k, n_loc)
    sel_loc = tournament_select(a_loc, k_loc, nblocks)
    panel_loc = a_loc[:, sel_loc]
    panels = jax.lax.all_gather(panel_loc, axis_name, axis=1, tiled=True)
    sels = jax.lax.all_gather(sel_loc, axis_name, axis=0, tiled=False)
    win = qrcp_select(panels, k)
    cols = (win // k_loc) * n_loc + sels[win // k_loc, win % k_loc]
    q, _ = tsqr(panels[:, win], nblocks=nblocks)         # replicated (m, k)
    r_loc = jnp.einsum("mk,mn->kn", q, a_loc, precision=HIGHEST)
    return q, r_loc, cols
