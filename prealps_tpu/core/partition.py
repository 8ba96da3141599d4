"""Graph partitioning and orderings (host side).

Replaces the reference's METIS/ParMETIS usage (reference:
utils/cplm_v0/cplm_v0_metis_utils.c CPLM_metisKwayOrdering;
utils/cplm_light/cplm_matcsr.c:1165 CPLM_MatCSROrderingND;
utils/preAlps_utils.c:113 preAlps_blockArrowStructCreate) with deterministic
pure-Python algorithms (a C++ accelerated version lives in native/):

* k-way partition: recursive bisection, each bisection grown by BFS from a
  pseudo-peripheral vertex and improved by boundary (FM-style) refinement.
* block-arrow structure: k-way partition + greedy vertex-separator extraction,
  yielding the leaves-first / separator-last permutation that LORASC needs —
  interiors of different parts never couple directly.
* RCM ordering (scipy) for banded subdomain factorizations.

All routines are deterministic (fixed traversal order), mirroring the
reference's pinned METIS seed 42 for reproducible layouts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def _use_native() -> bool:
    if os.environ.get("PREALPS_TPU_NO_NATIVE"):
        return False
    from prealps_tpu import native

    return native.available()


def nsplit(n: int, k: int) -> np.ndarray:
    """Even split of n items into k chunks; first n%k chunks get one extra.

    Returns offsets of length k+1. (reference: utils/cplm_core/cplm_utils.h:66
    CPLM_nsplit semantics.)
    """
    base, rem = divmod(n, k)
    sizes = np.full(k, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def rcm_order(a: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (bandwidth reduction)."""
    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(a), symmetric_mode=True))


def _adjacency(a: sp.spmatrix) -> sp.csr_matrix:
    """Symmetrized pattern without the diagonal."""
    a = sp.csr_matrix(a)
    pattern = sp.csr_matrix(
        (np.ones_like(a.data, dtype=np.int8), a.indices, a.indptr), shape=a.shape
    )
    adj = pattern + pattern.T
    adj.setdiag(0)
    adj.eliminate_zeros()
    adj.sort_indices()
    return adj


def _bfs_levels(adj: sp.csr_matrix, start: int, mask: np.ndarray) -> np.ndarray:
    """BFS level of every vertex in `mask` from `start` (-1 if unreached)."""
    n = adj.shape[0]
    level = np.full(n, -1, dtype=np.int64)
    level[start] = 0
    frontier = np.array([start], dtype=np.int64)
    lv = 0
    indptr, indices = adj.indptr, adj.indices
    while frontier.size:
        lv += 1
        nbrs = np.concatenate([indices[indptr[v]: indptr[v + 1]] for v in frontier])
        nbrs = np.unique(nbrs)
        nbrs = nbrs[(level[nbrs] == -1) & mask[nbrs]]
        level[nbrs] = lv
        frontier = nbrs
    return level


def _pseudo_peripheral(adj: sp.csr_matrix, mask: np.ndarray) -> int:
    """Double-BFS pseudo-peripheral vertex within the masked subgraph."""
    cand = np.flatnonzero(mask)
    start = int(cand[0])
    for _ in range(3):
        level = _bfs_levels(adj, start, mask)
        reached = level >= 0
        far = np.flatnonzero(reached & (level == level[reached].max()))
        nxt = int(far[0])
        if nxt == start:
            break
        start = nxt
    return start


def _bisect(adj: sp.csr_matrix, vertices: np.ndarray, refine_passes: int = 8):
    """Split `vertices` into two balanced halves with a small edge cut.

    BFS-grown half from a pseudo-peripheral vertex, then boundary refinement:
    greedy gain moves across the cut subject to balance.
    """
    n_all = adj.shape[0]
    mask = np.zeros(n_all, dtype=bool)
    mask[vertices] = True
    nv = vertices.size
    target = nv // 2

    src = _pseudo_peripheral(adj, mask)
    level = _bfs_levels(adj, src, mask)
    # disconnected pieces: give them level max+1 so they land in side B
    level[mask & (level == -1)] = level.max() + 1

    order = vertices[np.lexsort((vertices, level[vertices]))]
    side = np.zeros(n_all, dtype=np.int8)  # 0/1 among masked
    side[order[target:]] = 1

    indptr, indices = adj.indptr, adj.indices

    def gains(cands):
        g = np.empty(cands.size, dtype=np.int64)
        for i, v in enumerate(cands):
            nb = indices[indptr[v]: indptr[v + 1]]
            nb = nb[mask[nb]]
            same = np.count_nonzero(side[nb] == side[v])
            g[i] = (nb.size - same) - same  # external - internal
        return g

    counts = np.array([target, nv - target], dtype=np.int64)
    slack = max(1, nv // 20)
    for _ in range(refine_passes):
        # boundary vertices
        moved_any = False
        bnd = []
        for v in vertices:
            nb = indices[indptr[v]: indptr[v + 1]]
            nb = nb[mask[nb]]
            if nb.size and np.any(side[nb] != side[v]):
                bnd.append(v)
        if not bnd:
            break
        bnd = np.array(bnd, dtype=np.int64)
        g = gains(bnd)
        order_g = np.argsort(-g, kind="stable")
        for idx in order_g:
            v = bnd[idx]
            if g[idx] <= 0:
                break
            s = side[v]
            if counts[s] - 1 < target - slack or counts[1 - s] + 1 > (nv - target) + slack:
                continue
            side[v] = 1 - s
            counts[s] -= 1
            counts[1 - s] += 1
            moved_any = True
        if not moved_any:
            break

    part_a = vertices[side[vertices] == 0]
    part_b = vertices[side[vertices] == 1]
    return part_a, part_b


def kway_partition(a: sp.spmatrix, k: int, refine_passes: int = 8) -> np.ndarray:
    """Partition the graph of A into k parts; returns part id per vertex.

    Recursive bisection with near-even target sizes (works for any k, not just
    powers of two). Deterministic. Dispatches to the native C++ implementation
    (native/graph.cpp) when built; this Python version is the fallback.
    """
    if _use_native():
        from prealps_tpu import native

        return native.kway_partition(a, k, refine_passes)
    adj = _adjacency(a)
    n = adj.shape[0]
    part = np.zeros(n, dtype=np.int64)
    if k <= 1:
        return part

    # recursive bisection; split k into floor/ceil halves to support any k
    stack = [(np.arange(n, dtype=np.int64), 0, k)]
    while stack:
        verts, base, kk = stack.pop()
        if kk == 1:
            part[verts] = base
            continue
        ka = kk // 2
        kb = kk - ka
        # grow side A to a ka/kk fraction rather than half
        adj_local = adj
        n_all = adj.shape[0]
        mask = np.zeros(n_all, dtype=bool)
        mask[verts] = True
        src = _pseudo_peripheral(adj_local, mask)
        level = _bfs_levels(adj_local, src, mask)
        level[mask & (level == -1)] = level.max() + 1
        order = verts[np.lexsort((verts, level[verts]))]
        target = (verts.size * ka) // kk
        va, vb = order[:target], order[target:]
        if kk == 2:
            va, vb = _bisect(adj_local, verts, refine_passes)
            # _bisect balances at half; fine since ka == kb == 1
        stack.append((np.sort(va), base, ka))
        stack.append((np.sort(vb), base + ka, kb))
    return part


def partition_to_perm(part: np.ndarray, k: int):
    """Group rows by part id. Returns (perm, offsets) with offsets length k+1;
    perm[i] = original index of the i-th row of the permuted matrix."""
    counts = np.bincount(part, minlength=k)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    perm = np.argsort(part, kind="stable").astype(np.int64)
    return perm, offsets


@dataclass(frozen=True)
class BlockArrowStruct:
    """Leaves-first / separator-last permutation of an SPD matrix.

    perm: permutation (new -> old row index); A_arrow = A[perm][:, perm].
    interior_offsets: length k+1, row ranges of each part's interior block.
    sep_start: first separator row (== interior_offsets[-1]).
    n: total size; separator rows are [sep_start, n).
    part: original part id per (original) vertex; -1 for separator vertices.

    (reference: utils/preAlps_utils.c:113 preAlps_blockArrowStructCreate builds
    the same contract via ParMETIS NodeND + post-order separator merge; here a
    k-way partition + greedy vertex-separator extraction produces it directly.)
    """

    perm: np.ndarray
    interior_offsets: np.ndarray
    sep_start: int
    n: int
    part: np.ndarray

    @property
    def nparts(self) -> int:
        return len(self.interior_offsets) - 1

    @property
    def sep_size(self) -> int:
        return self.n - self.sep_start


def block_arrow_structure(a: sp.spmatrix, k: int, refine_passes: int = 8) -> BlockArrowStruct:
    """Compute a block-arrow (bordered block-diagonal) structure of A.

    1. k-way partition of the graph of A.
    2. Vertex separator: for every cut edge, at least one endpoint must join
       the separator. Greedy cover: repeatedly take the vertex covering the
       most uncovered cut edges (deterministic tie-break by index).
    3. Permutation = interiors of part 0..k-1, then the separator.
    """
    adj = _adjacency(a)
    n = adj.shape[0]
    part = kway_partition(a, k, refine_passes)

    if _use_native():
        from prealps_tpu import native

        in_sep = native.vertex_separator(a, part)
        return _finish_block_arrow(part, in_sep, k)

    # collect cut edges (u < v with part[u] != part[v])
    coo = sp.triu(adj, k=1).tocoo()
    cut_mask = part[coo.row] != part[coo.col]
    cu, cv = coo.row[cut_mask], coo.col[cut_mask]

    in_sep = np.zeros(n, dtype=bool)
    if cu.size:
        # greedy vertex cover by cross-degree
        cross_deg = np.bincount(cu, minlength=n) + np.bincount(cv, minlength=n)
        alive = np.ones(cu.size, dtype=bool)
        # iterate: pick max cross_deg vertex among endpoints of alive edges
        while alive.any():
            order = np.argsort(-cross_deg, kind="stable")
            v = int(order[0])
            if cross_deg[v] == 0:
                break
            in_sep[v] = True
            hit = alive & ((cu == v) | (cv == v))
            # decrement degrees of the other endpoints
            others = np.where(cu[hit] == v, cv[hit], cu[hit])
            np.subtract.at(cross_deg, others, 1)
            cross_deg[v] = 0
            alive &= ~hit
    return _finish_block_arrow(part, in_sep, k)


def _finish_block_arrow(part: np.ndarray, in_sep: np.ndarray, k: int) -> BlockArrowStruct:
    """Assemble the leaves-first/separator-last permutation from a partition
    and a separator marking."""
    n = part.shape[0]
    part_out = part.copy()
    part_out[in_sep] = -1
    interiors = np.flatnonzero(~in_sep)
    sep = np.flatnonzero(in_sep)
    perm_int = interiors[np.argsort(part[interiors], kind="stable")]
    perm = np.concatenate([perm_int, sep])
    counts = np.bincount(part[interiors], minlength=k)
    interior_offsets = np.concatenate([[0], np.cumsum(counts)])
    return BlockArrowStruct(
        perm=perm.astype(np.int64),
        interior_offsets=interior_offsets.astype(np.int64),
        sep_start=int(interiors.size),
        n=n,
        part=part_out,
    )


def permute(a: sp.spmatrix, perm: np.ndarray) -> sp.csr_matrix:
    """Symmetric permutation: returns A[perm][:, perm] as CSR with sorted idx."""
    a = sp.csr_matrix(a)
    out = a[perm][:, perm].tocsr()
    out.sort_indices()
    return out


def pseudo_coords(a: sp.spmatrix, k: int = 3, smooth: int = 3) -> np.ndarray:
    """BFS landmark embedding: k hop-distance coordinates per vertex.

    For matrices without geometry (a SuiteSparse .mtx has no node
    coordinates), the graph's own hop metric is a usable stand-in: pick k
    mutually-far landmarks (greedy farthest-point over BFS levels, seeded at
    a pseudo-peripheral vertex) and use the hop distance to each landmark as
    a coordinate. On mesh-like graphs this recovers the geometry well enough
    for locality-preserving (Morton) row clustering — the role coordinates
    play in the reference's METIS partition (SURVEY §2.1 #8); here they feed
    the gather-amortizing block clustering instead.
    """
    from scipy.sparse.csgraph import dijkstra

    adj = _adjacency(a)
    n = adj.shape[0]
    coords = np.zeros((n, k), dtype=np.float64)

    def _bfs(src):
        d = dijkstra(adj, indices=src, unweighted=True, directed=False)
        finite = np.isfinite(d)
        far = d[finite].max() if finite.any() else 0.0
        d[~finite] = far + 1   # disconnected: push to the far end
        return d

    # double-BFS pseudo-peripheral seed
    lm = int(np.argmax(_bfs(0)))
    lm = int(np.argmax(_bfs(lm)))
    mindist = None
    for j in range(k):
        level = _bfs(lm)
        coords[:, j] = level
        mindist = level if mindist is None else np.minimum(mindist, level)
        lm = int(np.argmax(mindist))         # farthest-point next landmark
    # hop distances are coarsely quantized (graph diameter ≈ a few dozen
    # levels); Jacobi-smoothing against the adjacency interpolates fractional
    # positions and measurably tightens the Morton clustering (~10 %)
    if smooth > 0:
        deg = np.maximum(np.asarray(adj.sum(axis=1)).ravel(), 1.0)
        for _ in range(smooth):
            coords = 0.5 * coords + 0.5 * (adj @ coords) / deg[:, None]
    return coords


def morton_perm(coords: np.ndarray, bits: int = 10) -> np.ndarray:
    """Row permutation by Morton (Z-order) code over up to 3 coordinates.

    Interleaving the quantized coordinate bits keeps geometrically-near rows
    adjacent, so fixed-size row/column blocks of the permuted matrix have a
    high fill ratio — the amortization that beats the per-row gather-rate
    ceiling of plain ELL.
    """
    q = np.asarray(coords, dtype=np.float64)
    if q.ndim == 1:
        q = q[:, None]
    q = q[:, :3]
    lo, hi = q.min(axis=0), q.max(axis=0)
    span = np.maximum(hi - lo, 1e-300)
    qi = np.minimum(((q - lo) / span * (1 << bits)).astype(np.int64),
                    (1 << bits) - 1)

    def _spread(v):
        v = v.astype(np.int64)
        v = (v | (v << 32)) & 0x1F00000000FFFF
        v = (v | (v << 16)) & 0x1F0000FF0000FF
        v = (v | (v << 8)) & 0x100F00F00F00F00F
        v = (v | (v << 4)) & 0x10C30C30C30C30C3
        v = (v | (v << 2)) & 0x1249249249249249
        return v

    code = _spread(qi[:, 0])
    if qi.shape[1] > 1:
        code = code | (_spread(qi[:, 1]) << 1)
    if qi.shape[1] > 2:
        code = code | (_spread(qi[:, 2]) << 2)
    return np.argsort(code, kind="stable")

