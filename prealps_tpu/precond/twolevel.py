"""Two-level block-Jacobi: subdomain inverses + a GenEO-style coarse space.

An addition in the spirit of LORASC (which deflates the global
Schur complement's low modes): block Jacobi leaves the inter-block low-energy
modes — for heterogeneous elasticity, near-rigid-body motions of each block —
untouched, which is exactly why its iteration count grows with the block
count (BASELINE.md Table 4). This preconditioner adds a coarse correction

    M⁻¹ = M_BJ⁻¹ + Z A_c⁻¹ Zᵀ,      A_c = Zᵀ A Z,

where Z stacks q low-energy modes PER BLOCK, computed on device by subspace
iteration on the explicit block inverses (the dominant eigenvectors of
A_b⁻¹ are the lowest modes of A_b). The coarse problem is tiny (nb·q) and
solved densely, replicated. Additive combination keeps M SPD for CG.

Everything heavy runs on device; only the (n × q) mode panel is downloaded
once to assemble A_c on the host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from prealps_tpu.ops.blockops import f64_traced

HIGHEST = jax.lax.Precision.HIGHEST


@f64_traced
def _coarse_solve(c, ac_inv):
    """c·A_c⁻¹ summed in f64: A_c⁻¹ is ill-conditioned and its row sums
    cancel, so an f32 accumulator's rounding swamps the coarse correction
    (f32 ECG on elasticity3d(20³): 1263 iterations with it, 657 without;
    f64 takes 299 before refinement restarts)."""
    return jnp.einsum("tc,cd->td", c.astype(jnp.float64),
                      ac_inv.astype(jnp.float64), precision=HIGHEST)


def block_low_modes(inv5: jax.Array, q: int = 6, iters: int = 6) -> jax.Array:
    """Per-block lowest-mode basis via subspace iteration on the explicit
    inverses. inv5: (nb, br, mbn, br, mbn) -> Y5: (nb, br, mbn, q),
    per-block orthonormal."""
    nb, br, mbn, _, _ = inv5.shape
    mb = br * mbn
    inv = inv5.reshape(nb, mb, mb)

    # deterministic start: per-component translations + index ramps
    y = np.zeros((mb, q), dtype=np.float64)
    comp = np.repeat(np.arange(br), mbn)     # (m, rl) convention: m-major
    ramp = np.tile(np.linspace(-1.0, 1.0, mbn), br)
    for j in range(q):
        c = j % br
        base = (comp == c).astype(np.float64)
        y[:, j] = base if j < br else base * ramp
    y0 = jnp.broadcast_to(jnp.asarray(y, inv.dtype), (nb, mb, q))

    def orthonormalize(yb):
        g = jnp.einsum("bmq,bmr->bqr", yb, yb, precision=HIGHEST)
        g = g + 1e-12 * jnp.eye(q, dtype=yb.dtype)
        l_fac = jax.lax.linalg.cholesky(g, symmetrize_input=True)
        eye = jnp.broadcast_to(jnp.eye(q, dtype=yb.dtype), (nb, q, q))
        linv = jax.lax.linalg.triangular_solve(
            l_fac, eye, left_side=True, lower=True
        )
        return jnp.einsum("bmq,brq->bmr", yb, linv, precision=HIGHEST)

    def body(_, yb):
        yb = jnp.einsum("bmn,bnq->bmq", inv, yb, precision=HIGHEST)
        return orthonormalize(yb)

    y_fin = jax.lax.fori_loop(0, iters, body, orthonormalize(y0))
    return y_fin.reshape(nb, br, mbn, q)


def coarse_matrix_host(a_pad: sp.csr_matrix, y5: np.ndarray, br: int) -> np.ndarray:
    """A_c = Zᵀ A Z on the host (setup only). y5: (nb, br, mbn, q) numpy.
    Z's rows follow the natural padded row ordering (node-major)."""
    nb, _, mbn, q = y5.shape
    mb = br * mbn
    n = a_pad.shape[0]
    assert n == nb * mb
    # (m, rl) -> natural local row rl*br + m
    rows = []
    cols = []
    vals = []
    for b in range(nb):
        blk = y5[b]                       # (br, mbn, q)
        nat = blk.transpose(1, 0, 2).reshape(mb, q)  # (rl, m) -> natural
        r0 = b * mb
        rr, cc = np.nonzero(np.ones((mb, q)))
        rows.append(r0 + rr)
        cols.append(b * q + cc)
        vals.append(nat[rr, cc])
    z = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, nb * q),
    ).tocsr()
    ac = (z.T @ a_pad @ z).toarray()
    return 0.5 * (ac + ac.T)


def coarse_apply(y5, ac_inv, r):
    """Z A_c⁻¹ Zᵀ r in lane-major: r (t, br, nrb) -> same shape."""
    nb, br, mbn, q = y5.shape
    t = r.shape[0]
    rb = r.reshape(t, br, nb, mbn).transpose(0, 2, 1, 3)      # (t, nb, br, mbn)
    c = jnp.einsum("bkrq,tbkr->tbq", y5, rb, precision=HIGHEST)
    c = c.reshape(t, nb * q)
    c = jnp.einsum("tc,cd->td", c, ac_inv, precision=HIGHEST)
    c = c.reshape(t, nb, q)
    w = jnp.einsum("bkrq,tbq->tbkr", y5, c, precision=HIGHEST)
    return w.transpose(0, 2, 1, 3).reshape(t, br, nb * mbn)


def geometric_rbm_modes(grid, br: int, nrb: int, mbn: int,
                        scale_d: np.ndarray | None = None,
                        perm: np.ndarray | None = None,
                        q: int | None = None) -> np.ndarray:
    """Per-block geometric rigid-body modes (the Nicolaides coarse space).

    The per-block LOW modes of the Dirichlet diagonal block vanish on the
    block boundary, so they cannot represent inter-block motion — measured:
    no iteration cut. Rigid-body modes of the block's node set do not
    vanish there and span exactly the near-null space block Jacobi misses
    (3 translations + 3 rotations for 3-D elasticity).

    grid: (nx, ny, nz) node dims, lexicographic x-fastest ordering (the
    built-in elasticity generator's layout, core/generators.py).
    scale_d: if the operator was symmetrically scaled (Ã = D A D), the
    near-null space of Ã is D⁻¹·RBM — pass the scaling diagonal in the
    PERMUTED/padded row order (perm applied, padding appended).
    Returns y5 (nb, br, mbn, q=6), per-block orthonormalised.
    """
    nx, ny, nz = (int(g) for g in grid)
    nb = nrb // mbn
    if q is None:
        q = 3 * (br - 1) if br == 2 else 6 if br == 3 else br
    n_nodes = nx * ny * nz
    j = np.arange(nrb)
    px = (j % nx).astype(np.float64)
    py = ((j // nx) % ny).astype(np.float64)
    pz = (j // (nx * ny)).astype(np.float64)
    pad = j >= n_nodes
    nraw = 12 if (br == 3 and q > 6) else 6
    modes = np.zeros((nrb, br, nraw), dtype=np.float64)
    # translations
    for k in range(min(br, 3)):
        modes[:, k, k] = 1.0
    if br == 3:
        # rotations about x/y/z: u = r × (p − c); centering per block below
        modes[:, 1, 3], modes[:, 2, 3] = -pz, py     # about x
        modes[:, 0, 4], modes[:, 2, 4] = pz, -px     # about y
        modes[:, 0, 5], modes[:, 1, 5] = -py, px     # about z
        if nraw == 12:
            # linear STRAIN modes u = ε·p (symmetric ε): with translations
            # and rotations these span all linear displacement fields —
            # the next polynomial tier above rigid-body motion
            modes[:, 0, 6] = px                       # exx
            modes[:, 1, 7] = py                       # eyy
            modes[:, 2, 8] = pz                       # ezz
            modes[:, 0, 9], modes[:, 1, 9] = py, px   # exy
            modes[:, 0, 10], modes[:, 2, 10] = pz, px # exz
            modes[:, 1, 11], modes[:, 2, 11] = pz, py # eyz
    modes[pad] = 0.0
    if scale_d is not None:
        d = np.asarray(scale_d, dtype=np.float64).reshape(nrb, br)
        # scaled system Ã = D A D: near-null(Ã) = D⁻¹ · RBM
        modes /= np.where(d[:, :, None] == 0.0, 1.0, d[:, :, None])
        modes[pad] = 0.0
    y = modes.reshape(nb, mbn, br, nraw).transpose(0, 2, 1, 3)
    # centre the arms per block and orthonormalise (condition of A_c);
    # padded-only blocks fall back to identity-ish columns
    out = np.zeros((nb, br, mbn, q), dtype=np.float64)
    for b in range(nb):
        m = y[b].transpose(1, 0, 2).reshape(mbn * br, nraw)  # natural rows
        # SVD-based column selection: kept columns are left singular
        # vectors, guaranteed to lie in span(modes) even when the block is
        # rank-deficient (unpivoted-QR Q columns past a rank drop need not).
        uu, sv, _ = np.linalg.svd(m, full_matrices=False)
        rank = int(np.sum(sv > 1e-12 * max(1.0, sv[0] if sv.size else 1.0)))
        cols = uu[:, :rank]
        o = np.zeros((mbn * br, q))
        ncols = min(cols.shape[1], q)
        o[:, :ncols] = cols[:, :ncols]
        out[b] = o.reshape(mbn, br, q).transpose(1, 0, 2)
    return out


def bj2l_apply(inv_flat: jax.Array, yq3: jax.Array, ac_inv: jax.Array,
               z: jax.Array, axis_name=None) -> jax.Array:
    """(M_BJ⁻¹ + Z A_c⁻¹ Zᵀ) z in lane-major, sharing one block transpose.

    inv_flat: (nb, mb, mb) flat block inverses (device_bj.bj_apply_flat
    layout); yq3: (nb, q, mb) per-block modes, the long mb axis minor;
    ac_inv: (nb_glob·q, nb_glob·q) dense coarse inverse, column index
    b·q + j (coarse_matrix_host convention).

    Under shard_map (axis_name set): inv_flat/yq3/z hold this shard's
    blocks, ac_inv is replicated; the coarse residual Zᵀz (nb·q·t numbers —
    tiny) is all-gathered, the dense coarse solve is replicated, and each
    shard applies only its local Z columns — the reference's rooted
    reduce/solve/bcast (lorasc.c:521-558) as a gather + replicated GEMM."""
    nb, mb, _ = inv_flat.shape
    q = yq3.shape[1]
    t, br, nrb = z.shape
    mbn = mb // br
    zb = z.reshape(t, br, nb, mbn).transpose(0, 2, 1, 3).reshape(t, nb, mb)
    w = jnp.einsum("bDS,tbS->tbD", inv_flat, zb, precision=HIGHEST)
    c = jnp.einsum("bqS,tbS->tbq", yq3, zb, precision=HIGHEST)
    c = c.reshape(t, nb * q)
    if axis_name is not None:
        c = jax.lax.all_gather(c, axis_name, axis=1, tiled=True)
    c = _coarse_solve(c, ac_inv).astype(z.dtype)
    if axis_name is not None:
        s = jax.lax.axis_index(axis_name)
        c = jax.lax.dynamic_slice_in_dim(c, s * nb * q, nb * q, axis=1)
    w = w + jnp.einsum("bqD,tbq->tbD", yq3, c.reshape(t, nb, q),
                       precision=HIGHEST)
    return (
        w.reshape(t, nb, br, mbn).transpose(0, 2, 1, 3)
         .reshape(t, br, nrb).astype(z.dtype)
    )
