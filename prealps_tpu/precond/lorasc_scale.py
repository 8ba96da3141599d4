"""LORASC at scale on one device: banded interiors + matrix-free device deflation.

Round-1's LORASC stored dense (ni × ni) interior inverses and solved the
deflation eigenproblem by forming the FULL Schur complement on the host —
toy-scale only. This module is the production redesign
(reference: src/preconditioners/lorasc.c:95-311 build, :368-618 apply,
lorasc_eigsolve.c:31-205 PARPACK deflation):

* **Interiors** Aii: batched block-banded Cholesky (direct/banded.py) after a
  per-part node-level RCM — n·band memory, GEMM-only solves. Assembly happens
  ON DEVICE by scattering the resident stencil blocks into band layout
  (no dense factor crosses the host link).
* **Separator** Agg: the same block-banded machinery with a single batch
  entry (replaces MUMPS, reference lorasc.c:248-257) — the separator's
  plane-union graph RCM-orders to a narrow band.
* **Deflation** S u = λ Agg u: the jittable Lanczos (ops/lanczos.py,
  replacing PARPACK mode 2) run entirely on device. S·v needs Aig/Agi
  products; instead of materialising them, both are computed with the FULL
  stencil SpMM on zero-embedded vectors: interior rows of A·(embed_sep v)
  ARE Aig·v, separator rows of A·(embed_int z) ARE Agi·z. The off-diagonal
  coupling rides the already-optimal SpMM kernel
  (the matrixVectorOp.c:24-96 AggInvxS analog, gather-free).
* **Apply**: runs in arrow coordinates via node-level gathers while the ECG
  operator stays in ORIGINAL (stencil) ordering — M⁻¹ = Π M_arrow⁻¹ Πᵀ is the
  same preconditioner, so the hot SpMM keeps its speed-of-light format
  instead of degrading to gather-ELL under a global permutation (the
  reference permutes globally because MPI ranks own the permuted panels;
  one device has no such constraint).

Vectors are lane-major (t, br, nrb) panels throughout (solvers/panels.py
"tbn"), matching the stencil fast path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from prealps_tpu.direct.banded import (
    BlockBandedCholesky,
    block_banded_cholesky,
    block_banded_matvec,
    block_banded_solve_t,
)

HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# host planning: node-level band layout of interiors and separator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArrowBandPlan:
    """Node-level block-arrow + band layout (host-side, all static)."""

    nparts: int
    br: int
    nrb: int
    # interiors
    bs_i: int
    nblk_i: int
    nbn_i: int                 # band node slots per part (= nblk_i*bs_i // br)
    int_nodes: np.ndarray      # (P, nbn_i) node id at band position, nrb = pad
    ni_dof: np.ndarray         # (P,) real interior dofs per part
    # separator
    bs_g: int
    nblk_g: int
    nsn: int                   # real separator nodes
    nsn_pad: int
    sep_nodes: np.ndarray      # (nsn_pad,) node id at band position, nrb = pad
    # per-node maps (device assembly inputs)
    part_arr: np.ndarray       # (nrb,) int32: part id, -1 for separator
    pos_arr: np.ndarray        # (nrb,) int32: band node position within part/sep

    @property
    def ng_pad(self) -> int:
        return self.nsn_pad * self.br

    @property
    def ng(self) -> int:
        return self.nsn * self.br


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def plan_arrow_bands(
    node_graph: sp.csr_matrix,
    node_part: np.ndarray,
    in_sep: np.ndarray,
    nparts: int,
    br: int,
    bs_multiple: int | None = None,
    interior_order: str = "auto",
) -> ArrowBandPlan:
    """Order each interior part and the separator at the NODE level for a
    small bandwidth and derive uniform static band shapes. Keeping all br
    dofs of a node adjacent makes every gather/scatter node-granular.

    interior_order: "natural" keeps each part's nodes in their given
    (lexicographic) order — on box-grid partitions that is cross-section-
    banded, while RCM's diagonal BFS level sets on a box are ~2× WIDER;
    "rcm" reorders (right for irregular partitions); "auto" tries both per
    part and keeps the narrower. The separator (a union of planes) always
    uses RCM."""
    from prealps_tpu.core.partition import rcm_order

    nrb = node_graph.shape[0]
    mult = bs_multiple or int(np.lcm(8, br))
    part_arr = np.where(in_sep, -1, node_part).astype(np.int32)
    pos_arr = np.zeros(nrb, dtype=np.int32)

    def _bw(sub, perm):
        coo = sub[perm][:, perm].tocoo()
        return int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0

    # interiors
    part_nodes = []
    bw_i = 1
    for p in range(nparts):
        nodes = np.flatnonzero(part_arr == p)
        sub = node_graph[nodes][:, nodes]
        nat = np.arange(nodes.size)
        if interior_order == "natural" or nodes.size <= 2:
            perm, bw_p = nat, _bw(sub, nat)
        elif interior_order == "rcm":
            perm = rcm_order(sub)
            bw_p = _bw(sub, perm)
        else:  # auto
            perm_r = rcm_order(sub)
            bw_r, bw_n = _bw(sub, perm_r), _bw(sub, nat)
            perm, bw_p = (nat, bw_n) if bw_n <= bw_r else (perm_r, bw_r)
        ordered = nodes[perm]
        pos_arr[ordered] = np.arange(nodes.size)
        part_nodes.append(ordered)
        bw_i = max(bw_i, bw_p)
    bs_i = _round_up(bw_i * br + br, mult)
    max_nodes = max((pn.size for pn in part_nodes), default=1)
    nbn_i = _round_up(max(max_nodes, 1), bs_i // br)
    nblk_i = nbn_i * br // bs_i
    int_nodes = np.full((nparts, nbn_i), nrb, dtype=np.int64)
    for p, pn in enumerate(part_nodes):
        int_nodes[p, : pn.size] = pn
    ni_dof = np.array([pn.size * br for pn in part_nodes], dtype=np.int64)

    # separator
    snodes = np.flatnonzero(part_arr == -1)
    nsn = snodes.size
    if nsn:
        sub = node_graph[snodes][:, snodes]
        perm = rcm_order(sub) if nsn > 2 else np.arange(nsn)
        ordered = snodes[perm]
        pos_arr[ordered] = np.arange(nsn)
        coo = sub[perm][:, perm].tocoo()
        bw_g = max(1, int(np.abs(coo.row - coo.col).max()) if coo.nnz else 1)
    else:
        ordered = snodes
        bw_g = 1
    bs_g = _round_up(bw_g * br + br, mult)
    nsn_pad = _round_up(max(nsn, 1), bs_g // br)
    nblk_g = nsn_pad * br // bs_g
    sep_nodes = np.full(nsn_pad, nrb, dtype=np.int64)
    sep_nodes[:nsn] = ordered

    return ArrowBandPlan(
        nparts=nparts, br=br, nrb=nrb,
        bs_i=bs_i, nblk_i=nblk_i, nbn_i=nbn_i, int_nodes=int_nodes,
        ni_dof=ni_dof,
        bs_g=bs_g, nblk_g=nblk_g, nsn=nsn, nsn_pad=nsn_pad,
        sep_nodes=sep_nodes,
        part_arr=part_arr, pos_arr=pos_arr,
    )


# ---------------------------------------------------------------------------
# device assembly: stencil blocks -> band (D, E)
# ---------------------------------------------------------------------------

def assemble_band_from_stencil(
    blocks_t: jax.Array,        # (S, br, br, nrb) lane-major stencil
    offsets: tuple,
    part_arr: jax.Array,        # (nrb,) int32
    pos_arr: jax.Array,         # (nrb,) int32
    nparts: int,
    nblk: int,
    bs: int,
    counts: jax.Array,          # (P,) real dofs per part (pad gets identity)
    separator: bool,
):
    """Scatter the resident stencil into batched block-banded (D, E).

    One fused scatter-add over all (offset, m, k, node) tuples. Only the
    lower triangle is scattered (each symmetric pair appears once across
    ±offset), then D is symmetrised. Entries whose endpoints are not both in
    the selected region (same interior part, resp. separator) are dropped —
    that is precisely the Aii / Agg restriction of the block-arrow form.
    """
    s_max, br, _, nrb = blocks_t.shape
    dtype = blocks_t.dtype
    size = nparts * nblk * bs * bs

    pos_h = jnp.stack([jnp.roll(pos_arr, -off) for off in offsets])   # (S, nrb)
    part_h = jnp.stack([jnp.roll(part_arr, -off) for off in offsets])

    pos_g = pos_arr[None, None, None, :]
    part_g = part_arr[None, None, None, :]
    pos_hb = pos_h[:, None, None, :]
    part_hb = part_h[:, None, None, :]
    m_i = jnp.arange(br)[None, :, None, None]
    k_i = jnp.arange(br)[None, None, :, None]

    if separator:
        valid = (part_g == -1) & (part_hb == -1)
        pid = jnp.zeros_like(part_g)
    else:
        valid = (part_g >= 0) & (part_hb == part_g)
        pid = jnp.maximum(part_g, 0)

    dr = pos_g * br + m_i
    dc = pos_hb * br + k_i
    lower = dr >= dc
    blk = dr // bs
    rl = dr % bs
    base = ((pid * nblk + blk) * bs + rl) * bs
    in_d = (dc // bs) == blk
    in_e = (dc // bs) == blk - 1

    vals = jnp.where(valid & lower, blocks_t, jnp.zeros((), dtype))
    idx_d = jnp.where(valid & lower & in_d, base + dc - blk * bs, size)
    idx_e = jnp.where(valid & lower & in_e, base + dc - (blk - 1) * bs, size)

    d = jnp.zeros((size,), dtype).at[idx_d.ravel()].add(
        jnp.where(in_d, vals, 0).ravel(), mode="drop"
    ).reshape(nparts, nblk, bs, bs)
    e = jnp.zeros((size,), dtype).at[idx_e.ravel()].add(
        jnp.where(in_e, vals, 0).ravel(), mode="drop"
    ).reshape(nparts, nblk, bs, bs)

    # symmetrise D from its lower triangle
    d_lo = jnp.tril(d)
    d = d_lo + jnp.swapaxes(jnp.tril(d, -1), -1, -2)

    # identity on padding rows
    rows = jnp.arange(nblk * bs)
    pad = (rows[None, :] >= counts[:, None]).astype(dtype)   # (P, nblk*bs)
    d = d.at[
        jnp.arange(nparts)[:, None], rows[None, :] // bs,
        rows[None, :] % bs, rows[None, :] % bs,
    ].add(pad)
    return d, e


# ---------------------------------------------------------------------------
# the preconditioner
# ---------------------------------------------------------------------------

@dataclass
class ScalableLorasc:
    """Device LORASC. apply() maps lane-major panels (t, br, nrb) -> same."""

    plan: ArrowBandPlan
    operands: dict = field(repr=False)   # device arrays, see build
    deflated: int = 0
    timings: dict = field(default_factory=dict)  # build stage wall-clock (s)
    factor_store: str = "f32"   # storage dtype of the banded factors

    def apply(self, r: jax.Array) -> jax.Array:
        return lorasc_apply(self.plan, self.operands, r)


# Node-major intermediates are FLAT (nrb+1, br·t), so each node's values are
# one contiguous row for the gathers/embeds. Interior band vectors are
# t-MAJOR (nblk, P, t, bs), keeping the long bs axis minor through every
# banded-solve scan step. Same math as the reference sweeps throughout.


def _gather_int(plan: ArrowBandPlan, ops, rn2: jax.Array) -> jax.Array:
    """(nrb+1, br·t) flat node-major -> interior band (nblk_i, P, t, bs_i)."""
    t = rn2.shape[1] // plan.br
    vi = rn2[ops["int_nodes"]]                      # (P, nbn, br·t)
    vi = vi.reshape(plan.nparts, plan.nbn_i, plan.br, t)
    vi = vi.transpose(0, 3, 1, 2).reshape(
        plan.nparts, t, plan.nblk_i, plan.bs_i)
    return vi.transpose(2, 0, 1, 3)


def _gather_sep(plan: ArrowBandPlan, ops, rn2: jax.Array) -> jax.Array:
    """(nrb+1, br·t) -> separator dofs (ng_pad, t)."""
    t = rn2.shape[1] // plan.br
    vg = rn2[ops["sep_nodes"]]                      # (nsn_pad, br·t)
    return vg.reshape(plan.ng_pad, t)


def _embed_int(plan: ArrowBandPlan, ops, wb: jax.Array) -> jax.Array:
    """Interior band (nblk_i, P, t, bs_i) -> flat node-major (nrb, br·t)."""
    t = wb.shape[2]
    w = wb.transpose(1, 2, 0, 3).reshape(plan.nparts, t, plan.nbn_i, plan.br)
    w = w.transpose(0, 2, 3, 1).reshape(
        plan.nparts * plan.nbn_i, plan.br * t)
    out = jnp.zeros((plan.nrb + 1, plan.br * t), wb.dtype)
    out = out.at[ops["int_nodes"].reshape(-1)].add(w)
    return out[:-1]


def _embed_sep(plan: ArrowBandPlan, ops, zg: jax.Array) -> jax.Array:
    """Separator dofs (ng_pad, t) -> flat node-major (nrb, br·t)."""
    t = zg.shape[1]
    w = zg.reshape(plan.nsn_pad, plan.br * t)
    out = jnp.zeros((plan.nrb + 1, plan.br * t), zg.dtype)
    out = out.at[ops["sep_nodes"]].add(w)
    return out[:-1]


def _to_node_major(r: jax.Array) -> jax.Array:
    """(t, br, nrb) -> (nrb+1, br·t) flat, trailing zero node (pad target)."""
    t, br, nrb = r.shape
    rn = jnp.transpose(r, (2, 1, 0)).reshape(nrb, br * t)
    return jnp.concatenate([rn, jnp.zeros_like(rn[:1])], axis=0)


def _from_node_major(plan: ArrowBandPlan, rn2: jax.Array) -> jax.Array:
    """(nrb, br·t) flat -> (t, br, nrb)."""
    nrb = rn2.shape[0]
    t = rn2.shape[1] // plan.br
    return jnp.transpose(rn2.reshape(nrb, plan.br, t), (2, 1, 0))


def _sep_band(plan: ArrowBandPlan, g: jax.Array) -> jax.Array:
    """(ng_pad, t) -> (1, nblk_g, bs_g, t) (block_banded_matvec layout —
    BUILD-path B·v only; the hot solves use the t-major layout below)."""
    return g.reshape(1, plan.nblk_g, plan.bs_g, -1)


def _sep_flat(plan: ArrowBandPlan, gb: jax.Array) -> jax.Array:
    return gb.reshape(plan.ng_pad, -1)


def _sep_band_t(plan: ArrowBandPlan, g: jax.Array) -> jax.Array:
    """(ng_pad, t) -> t-major band (nblk_g, 1, t, bs_g)."""
    t = g.shape[1]
    return g.reshape(plan.nblk_g, plan.bs_g, t).transpose(0, 2, 1)[:, None]


def _sep_flat_t(plan: ArrowBandPlan, gb: jax.Array) -> jax.Array:
    """(nblk_g, 1, t, bs_g) -> (ng_pad, t)."""
    t = gb.shape[2]
    return gb[:, 0].transpose(0, 2, 1).reshape(plan.ng_pad, t)



def _build_unroll() -> int:
    """lax.scan unroll for BUILD-path banded solves (Lanczos/sloc/lift).
    1 keeps the compile small; higher values pipeline the factor
    loads across scan steps at more compile time (PREALPS_BUILD_UNROLL)."""
    return int(os.environ.get("PREALPS_BUILD_UNROLL", "1"))


# jitted-program cache across builds (see build_scalable_lorasc: a fresh
# per-build @jax.jit re-lowers the whole program on every build). Keyed on
# everything the traces close over, INCLUDING the env knobs read at trace
# time (PREALPS_BUILD_UNROLL, PREALPS_TIMING_NO_COLLECTIVES).
_LANCZOS_FN_CACHE: dict = {}


def _lanczos_fn_key(plan, pencil, nev, ncv_eff, blk, nblocks, restarts,
                    dtype) -> str:
    import hashlib

    h = hashlib.sha1()
    for arr in (plan.int_nodes, plan.sep_nodes, plan.part_arr, plan.pos_arr,
                plan.ni_dof):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(str((
        plan.nparts, plan.br, plan.nrb, plan.bs_i, plan.nblk_i, plan.nbn_i,
        plan.bs_g, plan.nblk_g, plan.nsn, plan.nsn_pad,
        pencil, nev, ncv_eff, blk, nblocks, restarts, str(dtype),
        _build_unroll(),
        os.environ.get("PREALPS_TIMING_NO_COLLECTIVES", "0"),
    )).encode())
    return h.hexdigest()


def _fn_cache_get(key: str, make):
    """Shared insert-or-reuse for the cross-build jitted-program cache
    (one place for the eviction policy and the key discipline above)."""
    fn = _LANCZOS_FN_CACHE.get(key)
    if fn is None:
        fn = make()
        if len(_LANCZOS_FN_CACHE) >= 8:
            _LANCZOS_FN_CACHE.clear()
        _LANCZOS_FN_CACHE[key] = fn
    return fn


def _agg_solve(plan, ops, g: jax.Array, unroll=True) -> jax.Array:
    fac = BlockBandedCholesky(ops["agg_linv"], ops["agg_moff"], ops["agg_failed"])
    return _sep_flat_t(plan, block_banded_solve_t(fac, _sep_band_t(plan, g),
                                                  unroll=unroll))


def _aii_solve(plan, ops, vb: jax.Array, unroll=True) -> jax.Array:
    """unroll: True for the hot apply (pipelined factor loads); the BUILD
    path passes 1 — the solve sits inside Lanczos loop bodies there, and a
    fully unrolled body multiplies the compile time."""
    fac = BlockBandedCholesky(ops["aii_linv"], ops["aii_moff"], ops["aii_failed"])
    return block_banded_solve_t(fac, vb, unroll=unroll)


def _coarse_solve(ops: dict, c: jax.Array) -> jax.Array:
    """Λc⁻¹ c via the precomputed (host-f64) inverse Cholesky factor of
    Λc = ŴᵀAŴ: Λc⁻¹ = L⁻ᵀ L⁻¹ as two small (k×k)·(k×t) matmuls."""
    linv = ops["coarse_linv"]
    u = jnp.einsum("kj,jt->kt", linv, c, precision=HIGHEST)
    return jnp.einsum("jk,jt->kt", linv, u, precision=HIGHEST)


def lorasc_apply(plan: ArrowBandPlan, ops: dict, r: jax.Array) -> jax.Array:
    """M⁻¹ r (reference: lorasc.c:368-618 forward + backward sweeps), with
    Agi/Aig products via the full stencil SpMM on zero-embedded vectors.

    Two correction modes select at trace time:
    * σ (reference form): zg += E σ Eᵀ g — maps deflated pencil modes to
      exactly the deflation tolerance (lorasc_eigsolve.c:247).
    * balancing deflation ("w_lift" operands present): the BNN form
      M⁻¹ = Pᵀ M0⁻¹ P + Q with Q = Ŵ Λc⁻¹ Ŵᵀ, P = I − A Q, over the lifted
      basis Ŵ = [−Aii⁻¹Aig E; E] (so AŴ = [0; S E] is separator-supported
      and P costs no extra operator apply). SPD, and — unlike the σ form —
      free of σ-amplified components in the returned vectors, which is what
      capped f32 LORASC at ~2.3× the f64 iteration count."""
    from prealps_tpu.ops.spmm import stencil_bsr_spmm_t

    # the sweep's embedded SpMMs may ride a reduced-precision (bf16) copy
    # of A — a preconditioner-side perturbation only (lorasc_stencil.py
    # a_store="bf16"); the ECG iteration keeps the full-precision blocks
    a_t = ops.get("a_stencil_m", ops["a_stencil"])
    deflate = "w_lift" in ops
    rn = _to_node_major(r)
    vi = _gather_int(plan, ops, rn)
    vg = _gather_sep(plan, ops, rn)

    if deflate:
        # pre-projection P r = r − AŴ Λc⁻¹ (Ŵᵀ r): touches separator rows only
        c1 = jnp.einsum("kbn,tbn->kt", ops["w_lift"], r, precision=HIGHEST)
        vg = vg - jnp.einsum(
            "gk,kt->gt", ops["aw_sep"], _coarse_solve(ops, c1),
            precision=HIGHEST)

    # forward sweep: zi = Aii⁻¹ vi ; g = vg − Agi zi  (one SpMM)
    zi = _aii_solve(plan, ops, vi)
    y = stencil_bsr_spmm_t(a_t, _from_node_major(plan, _embed_int(plan, ops, zi)))
    agi_zi = _gather_sep(plan, ops, _to_node_major(y))
    g = (vg - agi_zi) * ops["sep_mask"][:, None]

    # separator solve (+ low-rank σ correction: zg += E σ Eᵀ g)
    zg = _agg_solve(plan, ops, g)
    if not deflate:
        corr = jnp.einsum("gk,gt->kt", ops["e_mat"], g, precision=HIGHEST)
        zg = zg + jnp.einsum(
            "gk,kt->gt", ops["e_mat"], corr * ops["sigma"][:, None],
            precision=HIGHEST
        )
    zg = zg * ops["sep_mask"][:, None]

    # backward sweep: wi = zi − Aii⁻¹ (Aig zg)  (one SpMM)
    y2 = stencil_bsr_spmm_t(a_t, _from_node_major(plan, _embed_sep(plan, ops, zg)))
    aig_zg = _gather_int(plan, ops, _to_node_major(y2))
    wi = zi - _aii_solve(plan, ops, aig_zg)

    w = _embed_int(plan, ops, wi) + _embed_sep(plan, ops, zg)
    out = _from_node_major(plan, w)
    if deflate:
        # post-projection + coarse solve: Pᵀ y + Q r = y + Ŵ Λc⁻¹ (c1 − AŴᵀy)
        d = jnp.einsum("gk,gt->kt", ops["aw_sep"], zg, precision=HIGHEST)
        out = out + jnp.einsum(
            "kbn,kt->tbn", ops["w_lift"], _coarse_solve(ops, c1 - d),
            precision=HIGHEST)
    return out


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _sep_node_owners(node_graph: sp.csr_matrix, plan: ArrowBandPlan,
                     part_arr: np.ndarray) -> np.ndarray:
    """Owner part of each separator node = the part it couples to most
    strongly (|A| mass; ties toward the lower id). Node-level analog of
    presc.py::separator_owners (reference: the ODB structure keeps each
    rank's separator rows local, preAlps_utils.c:521)."""
    g = node_graph.tocsr()
    owners = np.zeros(plan.nsn, dtype=np.int64)
    fill = np.zeros(plan.nparts, dtype=np.int64)
    for j in range(plan.nsn):
        u = int(plan.sep_nodes[j])
        cols = g.indices[g.indptr[u]: g.indptr[u + 1]]
        vals = np.abs(g.data[g.indptr[u]: g.indptr[u + 1]])
        parts = part_arr[cols]
        mask = parts >= 0
        if not np.any(mask):
            owners[j] = int(np.argmin(fill))
            fill[owners[j]] += 1
            continue
        w = np.zeros(plan.nparts)
        np.add.at(w, parts[mask], vals[mask])
        # near-ties (separator planes couple ~equally to both sides) go to
        # the least-loaded candidate — "lower id wins" made part 0 own most
        # of the separator (ns_max ~ nsn: quadratic memory + no parallelism;
        # the reference splits the separator evenly, CPLM_nsplit)
        cand = np.flatnonzero(w >= 0.99 * w.max())
        owners[j] = int(cand[np.argmin(fill[cand])])
        fill[owners[j]] += 1
    return owners


def _build_sloc_operands(plan: ArrowBandPlan, node_graph, a_stencil, dev,
                         dtype, schur: bool = True):
    """SSLOC / SALOC pencil operands (reference: presc.h:18-21).

    schur=True (SSLOC, presc.c:239-241): per part p the exact LOCAL Schur
    complement Sloc_p = Agg_pp − Agi_p Aii_p⁻¹ Aig_p over the separator rows
    OWNED by p — the block the reference extracts via the direct solver's
    partial factorization (mkl_pardiso_solver.c:131-141). Assembly runs on
    device: dense Aig panels are scatter-built from the resident stencil
    blocks (host ships only small int32 maps), the W = Aii⁻¹ Aig panel
    rides the
    already-factored banded interiors, and Sloc is one batched GEMM.

    schur=False (SALOC, presc_eigsolve.c:249-423): the pencil operand is
    Aloc_p = Agg_pp alone (no Schur correction) — same plumbing, the W GEMM
    skipped. Returns operands added to `dev` plus the owned-dof
    gather/scatter index map."""
    br = plan.br
    part_arr = plan.part_arr
    owners = _sep_node_owners(node_graph, plan, part_arr)
    P = plan.nparts
    counts = np.bincount(owners, minlength=P)
    nso = max(int(counts.max()), 1)

    # owned node lists + lookup: node id -> (owner, owned slot)
    own_nodes = np.full((P, nso), plan.nrb, dtype=np.int64)   # pad -> nrb
    owned_slot = np.full(plan.nrb + 1, nso, dtype=np.int64)   # dump slot
    owner_of_node = np.full(plan.nrb + 1, -1, dtype=np.int64)
    fill = np.zeros(P, dtype=np.int64)
    for j in range(plan.nsn):
        p = owners[j]
        u = int(plan.sep_nodes[j])
        own_nodes[p, fill[p]] = u
        owned_slot[u] = fill[p]
        owner_of_node[u] = p
        fill[p] += 1

    # owned dof -> separator band dof position (for gather/scatter of v):
    # sep band dof of node at sep position q is q*br + k
    sep_pos_of_node = np.full(plan.nrb + 1, plan.nsn_pad - 1, dtype=np.int64)
    sep_pos_of_node[plan.sep_nodes[: plan.nsn]] = np.arange(plan.nsn)
    own_mask = (own_nodes < plan.nrb)
    own_pos = sep_pos_of_node[np.minimum(own_nodes, plan.nrb)]
    own_dof = (own_pos[:, :, None] * br
               + np.arange(br)[None, None, :]).reshape(P, nso * br)
    own_dof_mask = np.repeat(own_mask, br, axis=1).astype(dtype)

    offsets = a_stencil.offsets
    S = len(offsets)
    nbn = plan.nbn_i

    # Aig scatter map: (S, P, nbn) owned slot of int_nodes + off, else dump
    int_nodes = plan.int_nodes
    aig_col = np.full((S, P, nbn), nso, dtype=np.int32)
    valid_band = int_nodes < plan.nrb
    for s, off in enumerate(offsets):
        nb = int_nodes + off
        ok = valid_band & (nb >= 0) & (nb < plan.nrb)
        nb_c = np.where(ok, nb, plan.nrb)
        same_owner = owner_of_node[nb_c] == np.arange(P)[:, None]
        aig_col[s] = np.where(ok & same_owner,
                              owned_slot[nb_c], nso).astype(np.int32)
    # Agg_pp scatter map: (S, P, nso) owned slot of own_nodes + off
    agg_col = np.full((S, P, nso), nso, dtype=np.int32)
    for s, off in enumerate(offsets):
        nb = own_nodes + off
        ok = own_mask & (nb >= 0) & (nb < plan.nrb)
        nb_c = np.where(ok, nb, plan.nrb)
        same_owner = owner_of_node[nb_c] == np.arange(P)[:, None]
        agg_col[s] = np.where(ok & same_owner,
                              owned_slot[nb_c], nso).astype(np.int32)

    int_nodes_c = jnp.asarray(np.minimum(int_nodes, plan.nrb - 1))
    own_nodes_c = jnp.asarray(np.minimum(own_nodes, plan.nrb - 1))
    band_ok = jnp.asarray(valid_band)
    aig_col_d = jnp.asarray(aig_col)
    agg_col_d = jnp.asarray(agg_col)

    c = nso * br

    @jax.jit
    def _sloc_part_fresh(stencil, linv_p, moff_p, ints_p, bok_p, aigc_p,
                         owns_p, omask_p, aggc_p):
        """One part's Sloc (c, c). Compiled ONCE, executed per part — the
        fully batched form needs ~1.6 GB of temporaries at n=148k."""
        bt = stencil.blocks_t
        # Aig_p: (nbn, nso+1, br, br) scatter from the resident stencil
        vals = jnp.transpose(bt[:, :, :, ints_p], (0, 3, 1, 2))
        vals = (vals * bok_p[None, :, None, None]).astype(dtype)
        aig = jnp.zeros((nbn, nso + 1, br, br), dtype)
        bidx = jnp.arange(nbn)[None, :]
        aig = aig.at[bidx, aigc_p].add(vals)
        aig = aig[:, :nso]
        aig_dof = jnp.transpose(aig, (0, 2, 1, 3)).reshape(nbn * br, c)

        # Agg_pp: (nso, nso+1, br, br)
        vals_g = jnp.transpose(bt[:, :, :, owns_p], (0, 3, 1, 2))
        vals_g = (vals_g * omask_p[None, :, None, None]).astype(dtype)
        agg = jnp.zeros((nso, nso + 1, br, br), dtype)
        jidx = jnp.arange(nso)[None, :]
        agg = agg.at[jidx, aggc_p].add(vals_g)
        agg = agg[:, :nso]
        agg_dof = jnp.transpose(agg, (0, 2, 1, 3)).reshape(c, c)

        if not schur:
            return 0.5 * (agg_dof + agg_dof.T)     # SALOC: Aloc_p = Agg_pp

        # W = Aii_p⁻¹ Aig_p on this part's banded factor (P-slice of 1)
        fac = BlockBandedCholesky(linv_p, moff_p,
                                  jnp.zeros((), jnp.bool_))
        vb = aig_dof.reshape(1, plan.nblk_i, plan.bs_i, c)
        vb = vb.transpose(1, 0, 3, 2)
        wb = block_banded_solve_t(fac, vb, unroll=_build_unroll())
        w_dof = wb.transpose(1, 0, 3, 2).reshape(plan.nblk_i * plan.bs_i, c)
        sloc = agg_dof - jnp.einsum("ic,id->cd", aig_dof, w_dof,
                                    precision=HIGHEST)
        return 0.5 * (sloc + sloc.T)

    # cached across builds (same rationale as _LANCZOS_FN_CACHE)
    _sloc_part = _fn_cache_get(
        _lanczos_fn_key(plan, "_sloc_part", nbn, nso, int(schur), 0, 0,
                        dtype),
        lambda: _sloc_part_fresh)
    parts = []
    bok_d = jnp.asarray(valid_band.astype(dtype))
    omask_d = jnp.asarray(own_mask.astype(dtype))
    for p in range(P):
        parts.append(_sloc_part(
            a_stencil,
            dev["aii_linv"][p: p + 1], dev["aii_moff"][p: p + 1],
            int_nodes_c[p], bok_d[p], aig_col_d[:, p],
            own_nodes_c[p], omask_d[p], agg_col_d[:, p],
        ))
    sloc_raw = jnp.stack(parts)

    @jax.jit
    def _sloc_factor(sloc):
        # identity on pad dofs keeps the batched Cholesky defined
        m = jnp.asarray(own_dof_mask)
        eye = jnp.eye(c, dtype=sloc.dtype)[None]
        sloc = sloc * (m[:, :, None] * m[:, None, :]) + eye * (
            1.0 - m[:, :, None] * eye)
        lfac = jax.lax.linalg.cholesky(sloc, symmetrize_input=True)
        bad = jnp.any(jnp.isnan(lfac))
        lfac = jnp.where(jnp.isnan(lfac), jnp.zeros_like(lfac), lfac)
        eye_b = jnp.broadcast_to(eye, lfac.shape)
        linv = jax.lax.linalg.triangular_solve(
            lfac, eye_b, left_side=True, lower=True)
        sloc_inv = jnp.einsum("pki,pkj->pij", linv, linv, precision=HIGHEST)
        return sloc, sloc_inv, bad

    sloc, sloc_inv, bad = _sloc_factor(sloc_raw)
    if bool(jax.device_get(bad)):
        raise FloatingPointError("PRESC pencil operand (Sloc/Aloc) is not SPD")
    dev["sloc"] = sloc
    dev["sloc_inv"] = sloc_inv
    dev["own_dof"] = jnp.asarray(own_dof)
    dev["own_dof_mask"] = jnp.asarray(own_dof_mask)
    return dev


def _host_refine_pairs(a: sp.csr_matrix, plan: ArrowBandPlan,
                       vecs_np: np.ndarray, deflation_tol: float,
                       resid_tol: float = 1e-3):
    """One-time float64 Rayleigh–Ritz refinement of the f32 Lanczos
    candidates on the HOST (round 3).

    Motivation (an f64 deflation study, examples/deflation_study_f64.py): in f64 the
    same algorithm reaches 70 iters at 75 kept pairs, while the f32 device
    pairs cost 166-169 — the gap is VECTOR noise, which forces the σ cap.
    The fix: project S and Agg onto span(candidates) in f64 using the
    original scipy operator (per-part splu interiors — the one-time host
    cost the reference pays inside PARPACK's f64 arithmetic throughout,
    eigsolver.c), re-solve the small generalized problem, and keep pairs
    by TRUE f64 residuals. Returns (theta (k',), e_ng (ng, k') f64).
    """
    import scipy.sparse.linalg as spla

    br = plan.br
    sep_nodes = plan.sep_nodes[: plan.nsn]
    sep_dofs = (sep_nodes[:, None] * br + np.arange(br)).reshape(-1)
    v = np.asarray(vecs_np[: plan.ng], dtype=np.float64)   # (ng, k)
    # drop numerically dependent candidates early (duplicates)
    q, rr = np.linalg.qr(v)
    keep = np.abs(np.diag(rr)) > 1e-7 * max(np.abs(rr).max(), 1e-30)
    v = q[:, : keep.size][:, keep]
    k = v.shape[1]
    if k == 0:
        return np.zeros(0), np.zeros((plan.ng, 0))

    agg = a[sep_dofs][:, sep_dofs].tocsr()
    sv = agg @ v
    for p in range(plan.nparts):
        int_nodes = np.flatnonzero(plan.part_arr == p)
        if int_nodes.size == 0:
            continue
        idofs = (int_nodes[:, None] * br + np.arange(br)).reshape(-1)
        aig = a[idofs][:, sep_dofs].tocsc()
        if aig.nnz == 0:
            continue
        lu = spla.splu(a[idofs][:, idofs].tocsc())
        sv -= aig.T @ lu.solve(aig @ v)
    bv = agg @ v
    gs = v.T @ sv
    gb = v.T @ bv
    gs = 0.5 * (gs + gs.T)
    gb = 0.5 * (gb + gb.T)
    # whiten B on the subspace (drops residual near-dependence)
    w, u = np.linalg.eigh(gb)
    good = w > max(w.max(), 1e-300) * 1e-10
    u = u[:, good] / np.sqrt(w[good])
    lam, c = np.linalg.eigh(u.T @ gs @ u)
    cc = u @ c
    # true f64 residuals: ‖S Vc − λ B Vc‖ / ‖B Vc‖
    svc = sv @ cc
    bvc = bv @ cc
    res = (np.linalg.norm(svc - bvc * lam[None, :], axis=0)
           / np.maximum(np.linalg.norm(bvc, axis=0), 1e-300))
    sel = (lam <= deflation_tol) & (lam > 0) & (res <= resid_tol)
    e = (v @ cc)[:, sel]
    # B-normalize the kept vectors (uᵀ Agg u = 1, the PARPACK convention)
    bn = np.sqrt(np.maximum(np.einsum("gk,gk->k", e, agg @ e), 1e-300))
    return lam[sel], e / bn[None, :]


def build_scalable_lorasc(
    a: sp.spmatrix,
    nparts: int,
    br: int = 3,
    grid: tuple[int, int, int] | None = None,
    deflation_tol: float = 1e-2,
    max_deflation: int = 64,
    ncv: int | None = None,
    dtype=np.float32,
    shift: float = 0.0,
    a_stencil=None,
    eig_resid_tol: float = 0.03,
    restarts: int = 5,
    pencil: str = "agg",
    host_refine: bool | None = None,
    correction: str = "sigma",
    node_part: np.ndarray | None = None,
    in_sep: np.ndarray | None = None,
    lanczos_block: int | None = None,  # panel width of the block Lanczos
                                       # (None = env PREALPS_LANCZOS_BLOCK,
                                       # default 0 = scalar iteration)
    factor_store: str | None = None,   # storage dtype of the banded factors
                                       # the APPLY streams: "f32", "bf16",
                                       # "auto" (None = env
                                       # PREALPS_FACTOR_STORE, default auto)
) -> ScalableLorasc:
    """Build the scalable LORASC for a stencil-structured operator `a`
    (already scaled/permuted as the solver will use it; ORIGINAL ordering).

    grid: (gx, gy, gz) node-grid dims for the geometric box partition; when
    None, the generic block-arrow partitioner is used on the node graph.
    a_stencil: an existing lane-major StencilBsrTMatrix of `a` (reused by the
    driver so the operator is uploaded once).
    correction: "sigma" (reference form, zg += E σ Eᵀ g) or "deflate"
    (balancing/BNN projection over the lifted basis — see lorasc_apply;
    robust in f32 where σ amplification forces the cap).
    """
    import time as _time

    from prealps_tpu.core.gridpart import collapse_to_nodes, grid_box_partition
    from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
    from prealps_tpu.ops.lanczos import lanczos_gen
    from prealps_tpu.ops.spmm import stencil_bsr_spmm_t

    timings: dict = {}
    _t0 = _time.time()

    def _mark(stage):
        nonlocal _t0
        now = _time.time()
        timings[stage] = round(now - _t0, 2)
        _t0 = now

    a = sp.csr_matrix(a)
    n = a.shape[0]
    assert n % br == 0
    nrb = n // br

    if a_stencil is None:
        a_stencil = csr_to_stencil_bsr_t(a, br=br, dtype=dtype)
        if a_stencil is None:
            raise ValueError("matrix is not stencil-structured")

    node_graph = collapse_to_nodes(a, br)
    if node_part is not None:
        # pinned block-arrow partition (the reference's custom-partition
        # workflow, preAlps_utils.c:168-193): node_part = part id per node,
        # in_sep marks separator nodes (or node_part = -1 there)
        node_part = np.asarray(node_part, dtype=np.int64).ravel()
        if in_sep is None:
            in_sep = node_part < 0
        in_sep = np.asarray(in_sep, dtype=bool).ravel()
        if node_part.shape[0] != nrb or in_sep.shape[0] != nrb:
            raise ValueError(
                f"node partition needs {nrb} entries, got "
                f"{node_part.shape[0]}")
        nparts = max(nparts, int(node_part.max()) + 1)
        node_part = np.maximum(node_part, 0)
        # validate: no interior coupling across parts (else it is not a
        # block-arrow partition and the sweep would silently be wrong)
        g = node_graph.tocoo()
        live = ~(in_sep[g.row] | in_sep[g.col])
        if np.any(node_part[g.row[live]] != node_part[g.col[live]]):
            raise ValueError(
                "pinned partition is not block-arrow: interior nodes of "
                "different parts are coupled outside the separator")
    elif grid is not None:
        gx, gy, gz = grid
        assert gx * gy * gz == nrb, (grid, nrb)
        node_part, in_sep = grid_box_partition(gx, gy, gz, nparts)
    else:
        from prealps_tpu.core.partition import block_arrow_structure

        arrow = block_arrow_structure(node_graph, nparts)
        node_part = np.maximum(arrow.part, 0)
        in_sep = arrow.part < 0

    plan = plan_arrow_bands(node_graph, node_part, in_sep, nparts, br)
    _mark("plan")

    dev = dict(
        a_stencil=a_stencil,
        int_nodes=jnp.asarray(plan.int_nodes, dtype=jnp.int32),
        sep_nodes=jnp.asarray(plan.sep_nodes, dtype=jnp.int32),
    )
    part_d = jnp.asarray(plan.part_arr)
    pos_d = jnp.asarray(plan.pos_arr)

    # --- assemble + factor interiors and separator (all on device) ---
    # NOTE: every jit here takes its device operands as ARGUMENTS — closing
    # over them would embed multi-GB constants into the lowered module
    # (jax warns "large amount of constants captured").
    # cached across builds (same rationale as _LANCZOS_FN_CACHE: a fresh
    # per-build @jax.jit re-lowers on every build)
    def _make_factor():
        @jax.jit
        def _factor(stencil, part_a, pos_a, shift_now):
            d_i, e_i = assemble_band_from_stencil(
                stencil.blocks_t, stencil.offsets, part_a, pos_a,
                plan.nparts, plan.nblk_i, plan.bs_i,
                jnp.asarray(plan.ni_dof), separator=False,
            )
            fac_i = block_banded_cholesky(d_i, e_i, shift=shift_now)
            d_g, e_g = assemble_band_from_stencil(
                stencil.blocks_t, stencil.offsets, part_a, pos_a,
                1, plan.nblk_g, plan.bs_g,
                jnp.asarray(np.array([plan.ng])), separator=True,
            )
            fac_g = block_banded_cholesky(d_g, e_g, shift=shift_now)
            return fac_i, fac_g, d_g, e_g

        return _factor

    _factor = _fn_cache_get(
        _lanczos_fn_key(plan, "_factor_stage", 0, 0, 0, 0, 0, dtype),
        _make_factor)

    # float32 builds of ill-conditioned operators can lose positive
    # definiteness during the block recursion; retry with growing diagonal
    # shifts (a shifted factor only weakens the preconditioner slightly)
    shift_now = shift
    for _ in range(4):
        fac_i, fac_g, d_g, e_g = _factor(a_stencil, part_d, pos_d, shift_now)
        if not (bool(fac_i.failed) or bool(fac_g.failed)):
            break
        shift_now = max(shift_now * 10, 1e-6)
    dev.update(
        aii_linv=fac_i.l_inv, aii_moff=fac_i.m_off, aii_failed=fac_i.failed,
        agg_linv=fac_g.l_inv, agg_moff=fac_g.m_off, agg_failed=fac_g.failed,
    )
    sep_mask = (np.arange(plan.ng_pad) < plan.ng).astype(dtype)
    dev["sep_mask"] = jnp.asarray(sep_mask)
    _mark("factor")

    if pencil in ("sloc", "saloc"):
        # PRESC pencils (reference presc.h:18-21): sloc = S u = λ Sloc u
        # with exact local Schur complements assembled on device; saloc =
        # S u = λ Aloc u with Aloc = blockdiag(Agg_pp) (same plumbing,
        # no Schur correction — presc_eigsolve.c:249-423)
        dev = _build_sloc_operands(plan, node_graph, a_stencil, dev, dtype,
                                   schur=pencil == "sloc")
        _mark(pencil)
    elif pencil != "agg":
        raise ValueError(f"unknown pencil {pencil!r} (agg | sloc | saloc)")

    # --- deflation eigensolve on device (replaces PARPACK) ---
    ng_pad = plan.ng_pad
    nev = min(max_deflation, max(plan.ng - 1, 1))
    # PARPACK uses ncv=2·nev+1 WITH implicit restarts (eigsolver.c:110,
    # maxit=200); the thick-restart Lanczos mirrors that (restarts>0).
    # A single pass (restarts=0) needs a larger basis to converge the same
    # pairs — unconverged ones are filtered (eig_resid_tol) either way.
    ncv_default = (2 * nev + 1) if restarts > 0 else (3 * nev + 1)
    ncv_eff = min(ncv or ncv_default, max(plan.ng - 1, 2))
    # block iteration by default (round 4, measured at n=148k het: 97
    # deflated pairs and ~1.1 s / 61 iters vs the scalar iteration's 75
    # pairs and 1.31 s / 89 — panel width resolves the clustered near-null
    # window the way the f64 study said it should). The shared policy
    # (ops/lanczos.py::resolve_block_policy) falls back to scalar for
    # restarts=0 single-pass requests and tiny/degenerate bases;
    # PREALPS_LANCZOS_BLOCK=0 restores the scalar iteration everywhere.
    from prealps_tpu.ops.lanczos import resolve_block_policy

    lanczos_block, lanczos_nblocks, restarts = resolve_block_policy(
        restarts, ncv_eff, plan.ng, blk=lanczos_block)

    # Reuse the jitted eigensolve across builds with the same plan/config:
    # a FRESH @jax.jit closure per build re-lowers the whole program even on
    # a warm in-process rebuild. The plan's
    # index arrays are baked into the trace as constants, so the key hashes
    # them (plus every closed-over scalar); ops/dg/eg/v0 are jit arguments
    # and may differ freely (e.g. new matrix values on an identical grid).
    @jax.jit
    def _lanczos_run_fresh(ops, dg, eg, v0):
        def s_apply_panel(v):
            # S V = Agg V − Agi Aii⁻¹ Aig V via two embedded stencil SpMMs;
            # v: (ng_pad, k) panel
            vhat = _from_node_major(plan, _embed_sep(plan, ops, v))
            y1 = stencil_bsr_spmm_t(ops["a_stencil"], vhat)
            y1n = _to_node_major(y1)
            agg_v = _gather_sep(plan, ops, y1n)
            aig_v = _gather_int(plan, ops, y1n)
            zi = _aii_solve(plan, ops, aig_v, unroll=_build_unroll())
            y2 = stencil_bsr_spmm_t(
                ops["a_stencil"], _from_node_major(plan, _embed_int(plan, ops, zi))
            )
            agi_zi = _gather_sep(plan, ops, _to_node_major(y2))
            sv = (agg_v - agi_zi) * ops["sep_mask"][:, None]
            # identity on padding keeps pad Ritz values at 1 (never deflated)
            return sv + v * (1.0 - ops["sep_mask"])[:, None]

        def s_apply(v):
            return s_apply_panel(v[:, None])[:, 0]

        def _own_gather(v):
            return (v[ops["own_dof"]]
                    * ops["own_dof_mask"][:, :, None])   # (P, nsd, k)

        def _own_scatter(yo, like):
            y = jnp.zeros_like(like)
            return y.at[ops["own_dof"]].add(
                yo * ops["own_dof_mask"][:, :, None])

        if pencil in ("sloc", "saloc"):
            def b_apply_panel(v):
                yo = jnp.einsum("pij,pjk->pik", ops["sloc"],
                                _own_gather(v), precision=HIGHEST)
                y = _own_scatter(yo, v)
                return (y * ops["sep_mask"][:, None]
                        + v * (1.0 - ops["sep_mask"])[:, None])

            def op_apply_panel(v):
                sv = s_apply_panel(v)
                zo = jnp.einsum("pij,pjk->pik", ops["sloc_inv"],
                                _own_gather(sv), precision=HIGHEST)
                z = _own_scatter(zo, sv)
                return (z * ops["sep_mask"][:, None]
                        + sv * (1.0 - ops["sep_mask"])[:, None])

            def op_apply(v):
                return op_apply_panel(v[:, None])[:, 0]
        else:
            def b_apply_panel(v):
                y = block_banded_matvec(dg, eg, _sep_band(plan, v))
                return _sep_flat(plan, y)

            def op_apply_panel(v):
                return _agg_solve(plan, ops, s_apply_panel(v), unroll=_build_unroll())

            def op_apply(v):
                return op_apply_panel(v[:, None])[:, 0]

        def b_apply(v):
            return b_apply_panel(v[:, None])[:, 0]

        if lanczos_block > 1 and restarts > 0:
            # block (panel) iteration: ~bt× fewer sequential dispatches for
            # the same basis dimension; width also resolves the clustered
            # near-null window better
            from prealps_tpu.ops.lanczos import block_lanczos_thick_restart

            lancz = block_lanczos_thick_restart(
                op_apply_panel, b_apply_panel, ng_pad,
                nblocks=lanczos_nblocks, nev=nev,
                bt=lanczos_block, restarts=restarts,
                dtype=jnp.dtype(dtype), v0=v0,
            )
        elif restarts > 0:
            from prealps_tpu.ops.lanczos import lanczos_thick_restart

            lancz = lanczos_thick_restart(
                op_apply, b_apply, ng_pad, ncv_eff, nev=nev,
                restarts=restarts, dtype=jnp.dtype(dtype), v0=v0,
            )
        else:
            lancz = lanczos_gen(
                op_apply, b_apply, ng_pad, ncv_eff, dtype=jnp.dtype(dtype),
                v0=v0,
            )
        vecs = lancz.eigvectors[:, :nev]
        # Subspace Rayleigh-Ritz refinement + TRUE residuals. Two thick-
        # restart artifacts poison the low-rank correction if candidates are
        # used raw: (a) Krylov-coupling residual estimates under-report for
        # locked directions (measured: 2551 vs 606 iters at n=148k het), and
        # (b) near-DUPLICATE converged pairs double-count a mode in E σ Eᵀ —
        # and a duplicate has zero residual, so no residual filter sees it
        # (measured: restarts=8 converged 46 'good' pairs yet cost 530 vs 108
        # iters at 18³). Projecting S, B onto span(candidates), whitening B
        # (dropping near-dependent directions = the duplicates), and
        # re-solving the small generalized problem fixes both at the cost of
        # one batched S·V panel and k×k eighs.
        from prealps_tpu.ops.lanczos import rayleigh_ritz_refine

        sv = s_apply_panel(vecs)
        bv = b_apply_panel(vecs)
        theta, vecs, bnorm2, resid = rayleigh_ritz_refine(vecs, sv, bv)
        return theta, vecs, bnorm2, resid

    v0 = jnp.asarray(sep_mask * 1e-2, dtype=dtype)
    if os.environ.get("PREALPS_DEBUG_KEEP_BANDED"):
        # expose the unfactored Agg band for build-stage profiling probes
        # (never shipped into the solve's operand pytree by default)
        dev["agg_band_d"], dev["agg_band_e"] = d_g, e_g
    _lanczos_run = _fn_cache_get(
        _lanczos_fn_key(plan, pencil, nev, ncv_eff, lanczos_block,
                        lanczos_nblocks, restarts, dtype),
        lambda: _lanczos_run_fresh)
    theta, vecs, bnorm2, resid = _lanczos_run(dev, d_g, e_g, v0)
    theta.block_until_ready()
    _mark("lanczos")

    # device-side static selection: theta ascending, keep λ ≤ tol among the
    # first `nev`; σ = (tol−λ)/λ (reference lorasc_eigsolve.c:247), unselected
    # columns get σ = 0 (no effect). CRITICAL: an UNCONVERGED Ritz pair
    # (large Lanczos residual) carries a huge σ on a wrong direction and
    # actively poisons the preconditioner (measured: 4190 vs 53 iterations
    # on 12³ het elasticity in f32) — filter on the residual estimate, which
    # PARPACK enforces internally via its convergence tolerance
    # (reference: eigsolver.c pdsaupd tol).
    ok = (
        (theta <= deflation_tol)
        & (bnorm2 > 0.5)
        & (resid <= eig_resid_tol * deflation_tol)
    )
    # σ cap via a floor on λ. The reference's exact σ=(tol−λ)/λ (f64) moves
    # every deflated mode to precisely tol; in f32 a large σ amplifies the
    # stored-vector noise by σ·eps and the refinement rounds grind on the
    # corrupted directions (measured 18³ het: floor 1e-6→507 total iters,
    # floor 0.1·tol→96). Under-corrected deep modes are cheap for ENLARGED
    # CG — up to t outlier modes ride the block directions — so the capped
    # σ keeps round-1 cost while fixing the noise. f64 keeps the reference
    # behavior (no meaningful cap).
    floor_frac = 0.1 if jnp.dtype(dtype) == jnp.float32 else 1e-4
    lam_eff = jnp.maximum(theta, deflation_tol * floor_frac)
    sigma = jnp.where(ok, (deflation_tol - lam_eff) / lam_eff, 0.0).astype(dtype)
    dev["e_mat"] = (vecs * dev["sep_mask"][:, None]).astype(dtype)
    dev["sigma"] = sigma
    deflated = int(jnp.sum(ok))

    # Host f64 refinement of the kept pairs (round 3): the f32 device
    # pairs carry vector noise that forces the σ cap above — the f64
    # deflation study shows the same algorithm at 70
    # vs 166 iterations when the vectors are accurate. One-time host cost
    # (splu per interior + k solves); the refined σ floor relaxes to
    # storage precision (f32 rounding of refined vectors ≈ 6e-8, so
    # σ ≲ 1e3 injects ≤ 1e-4 — enlarged CG absorbs the few outliers).
    # Default: refine only where it pays. σ form: refined pairs buy ~4 %
    # (159 vs 166 iters). deflate form: the same iteration count without it
    # (n=148k het, defl=256: 89 iters raw-device pairs vs 90 refined)
    # because the coarse solve floors Λc eigenvalues and the BNN projection
    # self-corrects pair noise; the serial host cost (splu per interior) was
    # the largest build stage, so it is OFF for correction="deflate".
    if host_refine is None:
        host_refine = (jnp.dtype(dtype) == jnp.float32
                       and pencil == "agg" and plan.ng > 0
                       and correction == "sigma")
    if host_refine and pencil == "agg":
        # prefilter on device before the D2H pull: only candidates with θ
        # anywhere near the deflation window and a sane residual estimate
        # are worth refining
        th_np = np.asarray(theta)
        rs_np = np.asarray(resid)
        bn_np = np.asarray(bnorm2)
        pre = np.flatnonzero(
            (th_np <= 3 * deflation_tol) & (bn_np > 0.25) & (rs_np <= 0.3))
        cand = np.asarray(vecs[:, jnp.asarray(pre)]) if pre.size else \
            np.zeros((ng_pad, 0))
        lam_r, e_r = _host_refine_pairs(a, plan, cand, deflation_tol)
        if lam_r.size:
            kk = lam_r.size
            e_pad = np.zeros((ng_pad, kk), dtype=np.float64)
            e_pad[: plan.ng] = e_r
            # σ floor stays at the f32-storage cap: relaxing it to 1e-3·tol
            # with f32-stored vectors poisons the apply (measured n=148k
            # het: 2398 iters vs 166) — the correction quality is then
            # limited by storage, not by pair accuracy
            lam_floor = np.maximum(lam_r, deflation_tol * float(floor_frac))
            dev["e_mat"] = jnp.asarray(e_pad.astype(dtype))
            dev["sigma"] = jnp.asarray(
                ((deflation_tol - lam_floor) / lam_floor).astype(dtype))
            deflated = int(kk)
        _mark("host_refine")

    if correction == "deflate":
        _attach_deflation_lift(plan, dev, dtype,
                               lam_floor=deflation_tol * float(floor_frac))
        _mark("lift")
    elif correction != "sigma":
        raise ValueError(f"unknown correction {correction!r} (sigma | deflate)")

    # Banded-factor storage precision for the HOT apply. The solve operator
    # L̃⁻ᵀL̃⁻¹ is exactly SPD for ANY stored factors (CG-safe); bf16 storage
    # halves the dominant byte stream of the apply (n=148k het: 61 → 64
    # iterations with correction="deflate"). Every BUILD-time consumer of
    # the factors (Lanczos deflation, sloc assembly, Ŵ lift) has already run
    # in f32 by this point — only the solve-loop applies see bf16. With
    # correction="sigma", bf16 factors cost 3.4× the iterations (440 vs 128,
    # 18³ het): σ amplifies deflated components by up to 1/λ, so that path
    # DEPENDS on M⁻¹ resolving them to storage precision. "auto" resolves to
    # f32 (config.factor_store_dtype); bf16 only on explicit request.
    from prealps_tpu.config import factor_store_dtype

    factor_store = factor_store_dtype(
        factor_store or os.environ.get("PREALPS_FACTOR_STORE"), dtype)
    if factor_store == "bf16":
        for _k in ("aii_linv", "aii_moff", "agg_linv", "agg_moff"):
            dev[_k] = dev[_k].astype(jnp.bfloat16)

    return ScalableLorasc(plan=plan, operands=dev, deflated=deflated,
                          timings=timings, factor_store=factor_store)


def _attach_deflation_lift(plan: ArrowBandPlan, dev: dict, dtype,
                           lam_floor: float) -> None:
    """Build the balancing-deflation operands from the final (E, σ>0) pairs:
    Ŵ = [−Aii⁻¹ Aig E; E] lane-major (k, br, nrb), AŴ's separator block
    S E (the interior block of AŴ vanishes by construction — the lift is
    the discrete harmonic extension, so P costs no operator apply), and the
    host-f64 inverse Cholesky factor of Λc = Ŵᵀ A Ŵ = Eᵀ (S E).

    The f32 motive (the σ-cap causal chain): the σ
    form returns vectors carrying σ-amplified mode components; f32 solver
    state rounds RELATIVE to that amplified magnitude, which is why the σ
    floor (and its ~2.3× iteration penalty vs f64) exists. The projection
    form handles those modes by an exact coarse solve and keeps every
    returned vector O(1)-scaled — the mode content of the residual stays at
    rounding level by the BNN self-correction, so f32 tracks the f64
    iteration counts. Per apply it costs two passes over Ŵ (tall GEMMs —
    GEMM work, no gathers).
    """
    from prealps_tpu.ops.spmm import stencil_bsr_spmm_t

    sel = np.flatnonzero(np.asarray(dev["sigma"]) > 0)
    if sel.size == 0:
        return  # nothing deflated: M0 alone (no coarse operands attached)
    e_sel = jnp.take(dev["e_mat"], jnp.asarray(sel, dtype=jnp.int32), axis=1)
    e_sel = e_sel * dev["sep_mask"][:, None]

    @jax.jit
    def _build_lift_fresh(ops, e):
        # one S·E sweep; its Aii⁻¹(Aig E) intermediate IS the interior lift
        e_node = _embed_sep(plan, ops, e)
        y1n = _to_node_major(
            stencil_bsr_spmm_t(ops["a_stencil"], _from_node_major(plan, e_node)))
        agg_e = _gather_sep(plan, ops, y1n)
        aig_e = _gather_int(plan, ops, y1n)
        zi = _aii_solve(plan, ops, aig_e, unroll=_build_unroll())
        w_int = _embed_int(plan, ops, zi)            # +Aii⁻¹ Aig E, node-major
        y2 = stencil_bsr_spmm_t(ops["a_stencil"], _from_node_major(plan, w_int))
        agi_zi = _gather_sep(plan, ops, _to_node_major(y2))
        sv = (agg_e - agi_zi) * ops["sep_mask"][:, None]
        w = _from_node_major(plan, e_node - w_int)   # (k, br, nrb) lane-major
        lc = jnp.einsum("gk,gj->kj", e, sv, precision=HIGHEST)
        return w, sv, lc

    # cached across builds (lift shapes depend on the deflated count k,
    # which the key carries; same rationale as _LANCZOS_FN_CACHE)
    _build_lift = _fn_cache_get(
        _lanczos_fn_key(plan, "_lift_stage", int(sel.size), 0, 0, 0, 0,
                        e_sel.dtype),
        lambda: _build_lift_fresh)
    w, sv, lc = _build_lift(dev, e_sel)
    # Λc is small (k×k) — eigendecompose in f64 on the host and FLOOR its
    # eigenvalues (≈ the pencil λ's, since E is B-normalized) at lam_floor.
    # The floor bounds ‖Q‖ ≤ 1/λf: computing Ŵᵀr in the working precision
    # carries eps·‖r‖ noise, which the coarse solve amplifies by 1/λ — with
    # exact Λc⁻¹ and λmin ~ 1e-7 (high contrast) the injected W-subspace
    # noise reaches O(‖r‖) and f32 convergence collapses (measured 14³ het:
    # 6429 vs 99 f64 iters). Floored, modes with λ ≥ λf still map to
    # exactly 1; sub-floor modes map to λ/λf — a factor 1/ε better than the
    # σ-cap's λ·ε/λf, the point of this correction mode.
    lc64 = np.asarray(lc, dtype=np.float64)
    lc64 = 0.5 * (lc64 + lc64.T)
    lam_c, u_c = np.linalg.eigh(lc64)
    lam_c = np.maximum(lam_c, lam_floor)
    # Λc̃⁻¹ = (Λ̃^{-1/2} Uᵀ)ᵀ (Λ̃^{-1/2} Uᵀ) — matches _coarse_solve's
    # linvᵀ·linv composition
    linv = (u_c / np.sqrt(lam_c)[None, :]).T
    dev["w_lift"] = w
    dev["aw_sep"] = sv
    dev["coarse_linv"] = jnp.asarray(linv.astype(dtype))
    # the σ path is superseded; drop its operands so the apply never pays
    # the E-read and the (large) e_mat does not sit in HBM twice
    dev["e_mat"] = jnp.zeros((dev["e_mat"].shape[0], 0), dtype=dtype)
    dev["sigma"] = jnp.zeros((0,), dtype=dtype)
