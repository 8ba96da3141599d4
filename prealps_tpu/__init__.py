"""prealps_tpu — communication-avoiding enlarged-Krylov solvers in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of NLAFET/preAlps
(reference: /root/reference): the ECG solver (Enlarged Conjugate Gradient,
orthomin / orthodir / fused single-reduction variants with dynamic
search-direction reduction), block-Jacobi and LORASC / PRESC Schur-complement
preconditioners, distributed row-partitioned SpMM, and the supporting host
toolchain (MatrixMarket IO, symmetric scaling, graph partitioning, block-arrow
layouts) — re-designed for accelerators rather than ported.

Layer map (mirrors SURVEY.md §1 of the reference analysis):
  solvers/    ECG (reference: src/solvers/ecg.c)
  precond/    block Jacobi, LORASC, PRESC (reference: src/preconditioners/*)
  ops/        SpMM, CholQR, Lanczos, TSQR (reference: utils/cplm_*, cholqr.c,
              eigsolver.c, iterativeKernels)
  direct/     batched subdomain factorizations (reference: PARDISO/MUMPS role)
  core/       host-side matrices, partitioning, layouts (reference: utils/
              preAlps_utils.c, operator.c, cplm_* CSR toolkit)
  parallel/   mesh + collective helpers (reference: raw MPI)
"""

__version__ = "0.1.0"

from prealps_tpu import config as config

__all__ = ["config", "__version__"]
