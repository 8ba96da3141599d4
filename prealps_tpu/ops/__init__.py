"""Device-side numeric kernels: SpMM, CholQR, Lanczos, batched factorizations.

Replaces the reference's MKL BLAS/SpBLAS kernel layer (reference:
utils/cplm_light/cplm_kernels.c) with jnp/XLA ops and one Pallas (Triton)
stencil kernel.
"""

from prealps_tpu.ops.formats import (
    EllMatrix,
    BlockEllMatrix,
    StencilBsrMatrix,
    StencilBsrTMatrix,
    csr_to_ell,
    csr_to_block_ell,
    csr_to_stencil_bsr,
    csr_to_stencil_bsr_t,
)
from prealps_tpu.ops.spmm import (
    ell_spmm,
    block_ell_spmm,
    stencil_bsr_spmm,
    stencil_bsr_spmm_t,
    panel_to_lane_major,
    panel_from_lane_major,
)

__all__ = [
    "EllMatrix",
    "BlockEllMatrix",
    "StencilBsrMatrix",
    "StencilBsrTMatrix",
    "csr_to_ell",
    "csr_to_block_ell",
    "csr_to_stencil_bsr",
    "csr_to_stencil_bsr_t",
    "ell_spmm",
    "block_ell_spmm",
    "stencil_bsr_spmm",
    "stencil_bsr_spmm_t",
    "panel_to_lane_major",
    "panel_from_lane_major",
]
