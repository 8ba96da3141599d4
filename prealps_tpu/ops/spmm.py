"""SpMM kernels: A (sparse) × X (n × t dense panel).

This is THE hot kernel of enlarged-Krylov methods (reference:
utils/cplm_v0/cplm_v0_matmult_v2.c performs it with mkl_dcsrmm per block).
The enlarging factor t is a batch dimension: every unit of work multiplies
one matrix entry (or block) into t right-hand sides at once.

Implementations:
* ell_spmm        — gather-based ELL, pure XLA. General matrices.
* dia_ell_spmm    — promoted diagonals as shifted FMAs + ELL remainder.
* block_ell_spmm  — block-ELL via gather + einsum, pure XLA.
* stencil_bsr_spmm_t — constant-offset block stencils on lane-major
  (t, br, nrb) panels: the Triton kernel stencil_spmm_triton_ext on the GPU,
  the XLA form stencil_spmm_xla_ext on the CPU and as the reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from prealps_tpu.ops.blockops import f64_traced
from prealps_tpu.ops.formats import BlockEllMatrix, DiaEllMatrix, EllMatrix

def ell_spmm(a: EllMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x with A in ELL format. x: (ncols, t) -> y: (n, t)."""
    gathered = x[a.cols]            # (n, L, t)
    return jnp.einsum("nl,nlt->nt", a.vals, gathered,
                      precision=jax.lax.Precision.HIGHEST)


def dia_ell_spmm(a: DiaEllMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x for hybrid DIA+ELL. x: (n, t) -> y: (n, t).

    Each promoted diagonal is one broadcast FMA over a statically shifted
    row-window of x (major-axis slices — cheap); only the remainder gathers.
    """
    n = a.shape[0]
    lo = max(-min(a.offsets), 0)
    hi = max(max(a.offsets), 0)
    x_pad = jnp.concatenate(
        [jnp.zeros((lo,) + x.shape[1:], x.dtype), x,
         jnp.zeros((hi,) + x.shape[1:], x.dtype)], axis=0)
    y = jnp.zeros_like(x[:n])
    for d, off in enumerate(a.offsets):
        xs = jax.lax.slice_in_dim(x_pad, lo + off, lo + off + n, axis=0)
        y = y + a.diags[d][:, None] * xs
    if a.rem is not None:
        y = y + ell_spmm(a.rem, x)
    return y


def block_ell_spmm(a: BlockEllMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x with A in block-ELL, pure XLA. x: (ncols_pad, t)."""
    nrb, s_max, bm, bk = a.blocks.shape
    t = x.shape[1]
    xb = x.reshape(-1, bk, t)       # (ncb, bk, t)
    gathered = xb[a.blkcols]        # (nrb, S, bk, t)
    y = jnp.einsum("rsmk,rskt->rmt", a.blocks, gathered,
                   preferred_element_type=x.dtype,
                   precision=jax.lax.Precision.HIGHEST)
    return y.reshape(nrb * bm, t)

def spmm(a, x: jax.Array) -> jax.Array:
    """Dispatch on format; dense jnp arrays fall through to a plain matmul.
    Stencil formats expect their native x layout ((n,t) resp. (t,br,nrb))."""
    from prealps_tpu.ops.formats import StencilBsrMatrix, StencilBsrTMatrix

    if isinstance(a, EllMatrix):
        return ell_spmm(a, x)
    if isinstance(a, DiaEllMatrix):
        return dia_ell_spmm(a, x)
    if isinstance(a, BlockEllMatrix):
        return block_ell_spmm(a, x)
    if isinstance(a, StencilBsrMatrix):
        return stencil_bsr_spmm(a, x)
    if isinstance(a, StencilBsrTMatrix):
        return stencil_bsr_spmm_t(a, x)
    return a @ x


def stencil_bsr_spmm(a, x: jax.Array) -> jax.Array:
    """y = A @ x for StencilBsrMatrix. x: (n, t) -> y: (n, t).

    One shifted read of x per stencil offset; boundary wrap-around from roll
    multiplies zero blocks, so the result is exact. Reads each operand ~once
    from HBM — the speed-of-light formulation for structured-grid operators.
    """
    nrb, s_max, br, _ = a.blocks.shape
    t = x.shape[1]
    x3 = x.reshape(nrb, br, t)
    y = jnp.zeros((nrb, br, t), dtype=x.dtype)
    for s, off in enumerate(a.offsets):
        xs = jnp.roll(x3, -off, axis=0) if off else x3
        y = y + jnp.einsum(
            "rmk,rkt->rmt", a.blocks[:, s], xs,
            preferred_element_type=x.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
    return y.reshape(nrb * br, t)


# Accumulation precision of the stencil SpMM. Elasticity rows sum to ~0 on
# the rigid-body modes, so for smooth panels |A·x| << |A|·|x| and an f32
# accumulation loses the low modes to rounding of size eps·|A|·|x|: f32 ECG
# then stalls near a 1e-2 relative residual. Every product of two f32 values
# is exact in f64, so f32 operands with an f64 accumulator give A·x to
# f32 rounding of the RESULT, and f32 ECG converges like f64 (measured on
# elasticity3d: 106 vs 89 iterations to 1e-3 where the f32 accumulator
# stalls). The f64 adds cost about 4-5 % of the apply on an H100 (PERF.md).
# Both implementations are traced by blockops.f64_traced, so the f64
# accumulator exists whatever the caller's x64 setting.


@f64_traced
def stencil_spmm_xla_ext(blocks_t, offsets, x_ext, halo: int):
    """Lane-major stencil SpMM in plain XLA: the CPU path and the reference
    the Triton kernel is tested against.

    blocks_t: (S, br, br, nrb); offsets: STATIC tuple of S ints;
    x_ext: (t, br, nrb + 2*halo) extended panel (halo already attached).
    The shifted views are static slices, stacked, and the contraction runs
    as a lax.scan over the offset axis (small traced graph), accumulating
    in f64."""
    s_max, br, _, nrb = blocks_t.shape
    t = x_ext.shape[0]
    xsh = jnp.stack([
        jax.lax.slice_in_dim(x_ext, halo + off, halo + off + nrb, axis=2)
        for off in offsets
    ]).astype(jnp.float64)  # (S, t, br, nrb)

    def step(y, inp):
        blk, xs = inp  # (br, br, nrb), (t, br, nrb)
        blk = blk.astype(jnp.float64)
        new = []
        for m in range(br):
            acc = y[m]
            for k in range(br):
                acc = acc + blk[m, k][None, :] * xs[:, k, :]
            new.append(acc)
        return tuple(new), None

    y0 = tuple(jnp.zeros((t, nrb), jnp.float64) for _ in range(br))
    y, _ = jax.lax.scan(step, y0, (blocks_t, xsh))
    return jnp.stack(y, axis=1).astype(x_ext.dtype)


# ---------------------------------------------------------------------------
# Triton stencil kernel (Pallas, backend="triton")
# ---------------------------------------------------------------------------
#
# The operator apply is pure bandwidth work: S·br² broadcast FMAs per node
# and right-hand side, no tensor-core content. The least traffic is one
# read of the block table and of x and one write of y. Each program owns
# one power-of-two chunk of nodes for a block of `tb` right-hand sides
# (t padded up and masked), reads every offset's window of x with an
# unaligned load (neighbouring windows overlap, so repeats hit L1/L2),
# accumulates all br output components in f64 registers, and writes y once.
# Nodes are the minor axis of every operand, so each load coalesces.


def _stencil_triton_kernel(x_ref, b_ref, y_ref, *, offsets, halo, br, nrb,
                           t_dim, chunk, tb):
    """x_ref: (t·br, nrb + 2·halo), row j·br + k = component k of rhs j;
    b_ref: (S·br², nrb), row (s·br + m)·br + k = block entry (m, k) of
    offset s; y_ref: (t·br, nrb)."""
    nodes = pl.program_id(0) * chunk + jnp.arange(chunk)
    cols = pl.program_id(1) * tb + jnp.arange(tb)
    nmask = nodes < nrb
    mask = (cols < t_dim)[:, None] & nmask[None, :]
    acc = [jnp.zeros((tb, chunk), jnp.float64) for _ in range(br)]
    for s, off in enumerate(offsets):
        win = (nodes + (halo + off))[None, :]
        for k in range(br):
            xk = plgpu.load(x_ref.at[(cols * br + k)[:, None], win],
                            mask=mask, other=0.0).astype(jnp.float64)
            for m in range(br):
                bv = plgpu.load(b_ref.at[(s * br + m) * br + k, nodes],
                                mask=nmask, other=0.0).astype(jnp.float64)
                acc[m] = acc[m] + bv[None, :] * xk
    for m in range(br):
        plgpu.store(y_ref.at[(cols * br + m)[:, None], nodes[None, :]],
                    acc[m].astype(y_ref.dtype), mask=mask)


@functools.partial(jax.jit, static_argnames=("offsets", "halo", "chunk",
                                             "interpret"))
@f64_traced
def stencil_spmm_triton_ext(blocks_t: jax.Array, offsets, x_ext: jax.Array,
                            halo: int, chunk: int = 64,
                            interpret: bool = False) -> jax.Array:
    """Triton stencil SpMM on a PRE-EXTENDED lane-major panel.

    blocks_t: (S, br, br, nrb) (f32, bf16 or f64; widened in registers);
    x_ext: (t, br, nrb + 2·halo) with halos attached (ring ppermute in the
    sharded driver, wrap slices on one shard). -> (t, br, nrb).
    Any t, nrb and halo: the node axis is masked to the chunk and t is
    tiled in blocks of at most 16 right-hand sides."""
    s_max, br, _, nrb = blocks_t.shape
    t_dim = x_ext.shape[0]
    tb = min(pl.next_power_of_2(t_dim), 16)
    kernel = functools.partial(
        _stencil_triton_kernel, offsets=tuple(offsets), halo=halo, br=br,
        nrb=nrb, t_dim=t_dim, chunk=chunk, tb=tb)
    y = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(nrb, chunk), pl.cdiv(t_dim, tb)),
        out_shape=jax.ShapeDtypeStruct((t_dim * br, nrb), x_ext.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="stencil_spmm",
    )(x_ext.reshape(t_dim * br, -1), blocks_t.reshape(s_max * br * br, nrb))
    return y.reshape(t_dim, br, nrb)


def stencil_impl() -> str:
    """Which stencil SpMM the product path runs: "triton" on the GPU,
    "xla" on the CPU (where a Triton kernel has no compiler)."""
    from prealps_tpu.config import on_accelerator

    return "triton" if on_accelerator() else "xla"


def stencil_spmm_ext(blocks_t, offsets, x_ext, halo: int):
    """The product path on a pre-extended panel (see stencil_impl)."""
    if stencil_impl() == "triton":
        return stencil_spmm_triton_ext(blocks_t, tuple(offsets), x_ext, halo)
    return stencil_spmm_xla_ext(blocks_t, offsets, x_ext, halo)


def attach_wrap_halo(xt: jax.Array, halo: int) -> jax.Array:
    """(t, br, nrb) -> (t, br, nrb + 2·halo) with the panel's own boundary
    slices as halos. Exact for stencil operators: a wrapped entry always
    multiplies a zero block (a boundary row has no neighbour there)."""
    nrb = xt.shape[-1]
    return jnp.concatenate([xt[:, :, nrb - halo:], xt, xt[:, :, :halo]],
                           axis=2)


def stencil_bsr_spmm_t(a, xt: jax.Array) -> jax.Array:
    """Lane-major stencil SpMM: xt (t, br, nrb) -> yt (t, br, nrb)."""
    halo = max(max(abs(o) for o in a.offsets), 0)
    return stencil_spmm_ext(a.blocks_t, a.offsets,
                            attach_wrap_halo(xt, halo), halo)


def _split_pair(y64, dtype):
    """f64 value -> (hi, lo) pair in `dtype` with hi + lo == y64 to ~48
    bits (f32) — the double-float form the refinement loops carry."""
    hi = y64.astype(dtype)
    return hi, (y64 - hi.astype(y64.dtype)).astype(dtype)


@f64_traced
def stencil_spmm_df_ext(blocks_t, offsets, x_ext, halo: int):
    """Lane-major stencil SpMM as a double-float pair: returns (y_hi, y_lo).

    Same contraction as stencil_spmm_xla_ext; the f64 accumulator (exact
    products of f32 operands) is split into two f32 halves instead of being
    rounded, so the pair carries ~48 mantissa bits. Used for the on-device
    iterative-refinement residual (parallel/driver.py), where a result
    rounded to f32 (~1e-7 relative to |A|·|x|) would cap the attainable
    tolerance. Run once per refinement round."""
    y = stencil_spmm_xla_ext(blocks_t, offsets,
                             x_ext.astype(jnp.float64), halo)
    return _split_pair(y, x_ext.dtype)


@f64_traced
def ell_gather_spmm_df(vals: jax.Array, gathered: jax.Array):
    """einsum('ml,mlt->mt') as a double-float pair: returns (y_hi, y_lo).

    vals: (m, L) ELL values; gathered: (m, L, t) pre-gathered x rows.
    f64 accumulation split into two halves (see stencil_spmm_df_ext)."""
    y = jnp.einsum("ml,mlt->mt", vals.astype(jnp.float64),
                   gathered.astype(jnp.float64),
                   precision=jax.lax.Precision.HIGHEST)
    return _split_pair(y, gathered.dtype)


def panel_to_lane_major(x: jax.Array, br: int) -> jax.Array:
    """(n, t) -> (t, br, nrb)"""
    n, t = x.shape
    return x.reshape(n // br, br, t).transpose(2, 1, 0)


def panel_from_lane_major(xt: jax.Array) -> jax.Array:
    """(t, br, nrb) -> (n, t)"""
    t, br, nrb = xt.shape
    return xt.transpose(2, 1, 0).reshape(nrb * br, t)
