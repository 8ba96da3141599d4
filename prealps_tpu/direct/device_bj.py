"""On-device block-Jacobi construction from the stencil operator.

The dense diagonal blocks a block-Jacobi preconditioner needs are
submatrices of A — and A is already resident on the device in stencil-BSR
form. Assembling the (nb, mb, mb) blocks on device from the stencil avoids
shipping hundreds of MB of dense factors from the host, and the
factorization itself (batched Cholesky → explicit inverse) is batched GEMM
work on the device.

Index convention: lane-major throughout. Blocks are stored 5-D
(nb, br, mbn, br, mbn) with node-local index minor, matching the (t, br, nrb)
panel layout, so the apply is one batched einsum with NO gathers/permutes:

    w[t, b, m, r] = Σ_{k,s} inv[b, m, r, k, s] · z[t, b, k, s]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def dense_blocks_from_stencil(blocks_t: jax.Array, offsets, mbn: int) -> jax.Array:
    """(S, br, br, nrb) stencil -> (nb, br, mbn, br, mbn) dense diagonal
    blocks, nb = nrb // mbn (must divide). Couplings that cross block
    boundaries are dropped (that's what makes it block-Jacobi)."""
    s_max, br, _, nrb = blocks_t.shape
    assert nrb % mbn == 0, "mbn must divide the node count"
    nb = nrb // mbn

    r = jnp.arange(nrb)
    b_idx = r // mbn
    rl = r % mbn
    dense = jnp.zeros((nb, br, mbn, br, mbn), blocks_t.dtype)
    for s, off in enumerate(offsets):
        tgt = rl + off
        valid = (tgt >= 0) & (tgt < mbn)
        tgt_safe = jnp.clip(tgt, 0, mbn - 1)
        for m in range(br):
            for k in range(br):
                vals = jnp.where(valid, blocks_t[s, m, k], 0.0)
                dense = dense.at[b_idx, m, rl, k, tgt_safe].add(vals)
    return dense


def batched_spd_inverse(dense5: jax.Array, method: str = "chol") -> jax.Array:
    """Explicit inverse of each (mb × mb) SPD block; input/output 5-D
    lane-major layout (see module docstring)."""
    nb, br, mbn, _, _ = dense5.shape
    mb = br * mbn
    a = dense5.reshape(nb, mb, mb)
    if method == "chol":
        chol = jax.lax.linalg.cholesky(a, symmetrize_input=True)
        eye = jnp.broadcast_to(jnp.eye(mb, dtype=a.dtype), (nb, mb, mb))
        linv = jax.lax.linalg.triangular_solve(
            chol, eye, left_side=True, lower=True, transpose_a=False
        )
        inv = jnp.einsum("bki,bkj->bij", linv, linv, precision=HIGHEST)
    elif method == "newton":
        # Newton–Schulz: X_{k+1} = X_k (2I − A X_k); init guarantees
        # convergence for SPD A. Pure batched GEMMs.
        norm1 = jnp.max(jnp.sum(jnp.abs(a), axis=2), axis=1)
        x = (a / (norm1 * norm1)[:, None, None]).transpose(0, 2, 1)
        eye2 = 2.0 * jnp.eye(mb, dtype=a.dtype)

        def body(_, x):
            ax = jnp.einsum("bij,bjk->bik", a, x, precision=HIGHEST)
            return jnp.einsum("bij,bjk->bik", x, eye2[None] - ax, precision=HIGHEST)

        x = jax.lax.fori_loop(0, 50, body, x)
        inv = 0.5 * (x + jnp.swapaxes(x, 1, 2))
    else:
        raise ValueError(f"unknown method {method!r}")
    return inv.reshape(nb, br, mbn, br, mbn)


def bj_apply_lane_major(inv5: jax.Array, z: jax.Array) -> jax.Array:
    """z: (t, br, nrb) -> (t, br, nrb) with nrb = nb*mbn.

    bf16-stored inverses run bf16 products with f32 accumulation: the
    apply is bandwidth bound on the inverse blocks, so halving their bytes
    is the point. The 0.3% matrix rounding is a FIXED SPD perturbation —
    preconditioner quality unchanged. The INPUT must not be rounded the
    same way: a bare z→bf16 cast makes the effective M nonlinear at ~4e-3,
    which breaks the ECG orthogonalisation recurrences (measured 7×
    iteration blow-up). Instead z is split into two bf16 pieces stacked on
    the t axis — B is read ONCE, compute doubles, and M̃ stays linear to
    ~1e-6."""
    nb, br, mbn, _, _ = inv5.shape
    t = z.shape[0]
    zb = z.reshape(t, br, nb, mbn).transpose(0, 2, 1, 3)       # (t, nb, br, mbn)
    if inv5.dtype == jnp.bfloat16:
        zh = zb.astype(jnp.bfloat16)
        zl = (zb - zh.astype(zb.dtype)).astype(jnp.bfloat16)
        z2 = jnp.concatenate([zh, zl], axis=0)                 # (2t, nb, br, mbn)
        w2 = jnp.einsum("bmrks,tbks->tbmr", inv5, z2,
                        preferred_element_type=jnp.float32)
        w = w2[:t] + w2[t:]
    else:
        w = jnp.einsum("bmrks,tbks->tbmr", inv5, zb, precision=HIGHEST)
    return w.transpose(0, 2, 1, 3).reshape(t, br, nb * mbn).astype(z.dtype)


def bj_apply_flat(inv_flat: jax.Array, z: jax.Array) -> jax.Array:
    """z: (t, br, nrb) -> (t, br, nrb) with FLAT (nb, mb, mb) inverses.

    Same math as bj_apply_lane_major as one plain batched GEMM over
    (nb, mb, mb) blocks."""
    nb, mb, _ = inv_flat.shape
    t, br, nrb = z.shape
    mbn = mb // br
    zb = z.reshape(t, br, nb, mbn).transpose(0, 2, 1, 3).reshape(t, nb, mb)
    w = jnp.einsum("bDS,tbS->tbD", inv_flat, zb, precision=HIGHEST)
    return (
        w.reshape(t, nb, br, mbn).transpose(0, 2, 1, 3)
         .reshape(t, br, nrb).astype(z.dtype)
    )


def build_device_block_jacobi(blocks_t, offsets, mbn: int, method: str = "chol"):
    """Stencil -> explicit block inverses, entirely on device."""
    dense = dense_blocks_from_stencil(blocks_t, offsets, mbn)
    return batched_spd_inverse(dense, method)


def build_device_block_jacobi_flat(blocks_t, offsets, mbn: int,
                                   method: str = "chol"):
    """Stencil -> FLAT (nb, mb, mb) explicit block inverses (bj_apply_flat)."""
    inv5 = build_device_block_jacobi(blocks_t, offsets, mbn, method)
    nb, br, mbn_, _, _ = inv5.shape
    return inv5.reshape(nb, br * mbn_, br * mbn_)


# ---------------------------------------------------------------------------
# Deduped block Jacobi: identical diagonal blocks stored (and READ) once
# ---------------------------------------------------------------------------
#
# Constant-coefficient stencil operators (the reference's own elasticity
# benchmark family, examples/test_ecg_petsc_ela.c DMDA grids) repeat their
# diagonal blocks: with the block boundary aligned to a full grid z-slab
# (mbn = nx*ny nodes), every interior slab assembles the SAME dense matrix —
# symmetric RAC scaling preserves this (interior diagonals are constant).
# Grouping bitwise-equal slabs turns the BJ apply from a bandwidth-bound read
# of n·mb·4 bytes (600 MB at n=148k/mb=1008) into ~4 unique-inverse reads +
# GEMMs with a 400-column batched panel. Layered-het media dedupe too
# (period-2 slabs), and arbitrary matrices simply fall back (every slab
# unique).


def stencil_slab_groups(blocks_host, mbn: int):
    """Group bitwise-identical diagonal slabs of a host stencil array.

    blocks_host: (nrb, S, br, br) numpy (csr_to_stencil_bsr layout).
    Returns (rep_idx, groups): rep_idx tuple of representative block indices,
    groups tuple of int tuples (block ids per group). Grouping keys on the
    full slab (conservative: equal diag blocks with different off-slab
    couplings split unnecessarily — never wrong).
    """
    import numpy as np

    nrb = blocks_host.shape[0]
    if nrb % mbn:
        return None
    nb = nrb // mbn
    flat = np.ascontiguousarray(blocks_host).reshape(nb, -1)
    seen = {}
    groups = []
    for b in range(nb):
        key = flat[b].tobytes()
        g = seen.get(key)
        if g is None:
            seen[key] = len(groups)
            groups.append([b])
        else:
            groups[g].append(b)
    rep_idx = tuple(g[0] for g in groups)
    return rep_idx, tuple(tuple(g) for g in groups)


def build_device_block_jacobi_grouped(blocks_t, offsets, mbn: int,
                                      rep_idx, method: str = "chol"):
    """Invert only the unique diagonal blocks: (ng, br, mbn, br, mbn)."""
    gather = jnp.concatenate([
        jnp.arange(r * mbn, (r + 1) * mbn, dtype=jnp.int32) for r in rep_idx
    ])
    reps = blocks_t[:, :, :, gather]         # (S, br, br, ng*mbn)
    dense = dense_blocks_from_stencil(reps, offsets, mbn)
    return batched_spd_inverse(dense, method)


def bj_apply_grouped(inv_u: jax.Array, groups, z: jax.Array) -> jax.Array:
    """z: (t, br, nrb) -> (t, br, nrb), reading each unique inverse ONCE.

    groups: static tuple of block-id tuples (from stencil_slab_groups). Each
    group's members batch into one (mb × mb)·(mb × |g|·t) GEMM on a wide
    panel instead of a stream of per-block copies."""
    ng, br, mbn, _, _ = inv_u.shape
    t = z.shape[0]
    nrb = z.shape[2]
    nb = nrb // mbn
    zb = z.reshape(t, br, nb, mbn).transpose(0, 2, 1, 3)   # (t, nb, br, mbn)
    out = jnp.zeros_like(zb)
    for g, members in enumerate(groups):
        idx = jnp.asarray(members, dtype=jnp.int32)
        zg = zb[:, idx]                                    # (t, |g|, br, mbn)
        wg = jnp.einsum("mrks,tbks->tbmr", inv_u[g], zg,
                        precision=HIGHEST)
        out = out.at[:, idx].set(wg)
    return out.transpose(0, 2, 1, 3).reshape(t, br, nrb).astype(z.dtype)


def csr_slab_groups(a_csr, rows_per_block: int):
    """Host-side slab grouping straight from the (scaled, padded) CSR.

    Signature = (row-lengths, relative column indices, values) of each
    rows_per_block row slice — bitwise. Conservative superset of the dense
    diag-block equality used by the apply (includes off-slab couplings), so
    grouping can only over-split, never merge unequal blocks.
    Returns (rep_idx, groups) like stencil_slab_groups, or None if
    rows_per_block does not divide n.
    """
    import numpy as np
    import scipy.sparse as sp

    a_csr = sp.csr_matrix(a_csr)
    n = a_csr.shape[0]
    if n % rows_per_block:
        return None
    nb = n // rows_per_block
    indptr, indices, data = a_csr.indptr, a_csr.indices, a_csr.data
    seen, groups = {}, []
    for b in range(nb):
        r0 = b * rows_per_block
        p0, p1 = indptr[r0], indptr[r0 + rows_per_block]
        key = (
            np.diff(indptr[r0:r0 + rows_per_block + 1]).tobytes()
            + (indices[p0:p1] - r0).tobytes()
            + data[p0:p1].tobytes()
        )
        g = seen.get(key)
        if g is None:
            seen[key] = len(groups)
            groups.append([b])
        else:
            groups[g].append(b)
    return tuple(g[0] for g in groups), tuple(tuple(g) for g in groups)


# Module-level jitted builders: a fresh jax.jit() wrapper per solver build
# re-lowers on every build (lorasc_scale._LANCZOS_FN_CACHE note). These
# persist for the process, so warm rebuilds hit the jit cache directly.
build_device_block_jacobi_jit = jax.jit(
    build_device_block_jacobi, static_argnames=("mbn", "method"))
build_device_block_jacobi_flat_jit = jax.jit(
    build_device_block_jacobi_flat, static_argnames=("mbn", "method"))
build_device_block_jacobi_grouped_jit = jax.jit(
    build_device_block_jacobi_grouped,
    static_argnames=("mbn", "method", "rep_idx"))
