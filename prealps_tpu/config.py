"""Global configuration: the platform policy and the compile cache.

The reference library (NLAFET/preAlps) is float64 everywhere (C99 + MKL).
This framework decides precision, panel layout and kernel choice from one
question, :func:`on_accelerator`: is the run on a GPU or on the CPU?

* On the GPU: float32 vectors with every matmul at HIGHEST precision (true
  f32, never TF32 — ECG's A-orthonormalisation fails in TF32), plus
  iterative refinement to reach tolerances below the f32 floor
  (parallel/driver.DistributedECG); the lane-major ``tbn`` panel layout for
  stencil and DIA operators; the Triton stencil SpMM (ops/spmm.py).
* On the CPU: float64, the bit-comparable correctness path of the test
  suite, with the XLA stencil SpMM.

A user who asks for a precision (``--dtype f64``) gets it on either.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def on_accelerator() -> bool:
    """True when JAX runs on a GPU, False on the CPU. Every platform-keyed
    decision in the package goes through this one function."""
    return jax.default_backend() == "gpu"


def solve_dtype(requested=None):
    """Working precision of a solve: the user's choice ("f32"/"f64" or a
    numpy dtype) when given, else float32 + refinement on the GPU and
    float64 on the CPU. Enables x64 whenever the answer is float64."""
    if requested is not None:
        dt = np.dtype({"f32": np.float32, "f64": np.float64}.get(
            requested, requested))
    else:
        dt = np.dtype(np.float32 if on_accelerator() else np.float64)
    if dt == np.float64:
        jax.config.update("jax_enable_x64", True)
    return dt.type


def panel_layout(fmt: str, precond: str | None = None) -> str:
    """Default panel layout for a storage format: lane-major ``tbn`` for
    stencil/DIA operators on the GPU (the layout the Triton stencil kernel
    reads) and wherever two-level block Jacobi needs it; ``nt`` otherwise."""
    if fmt not in ("stencil", "dia"):
        return "nt"
    if on_accelerator() or precond in ("bj2l", "block_jacobi_2l"):
        return "tbn"
    return "nt"


def factor_store_dtype(requested: str | None, dtype) -> str:
    """Storage dtype of the banded LORASC factors: "f32" unless the caller
    asks for "bf16" explicitly (f64 builds always store f64 factors)."""
    store = requested or "auto"
    if store not in ("auto", "f32", "bf16"):
        raise ValueError(f"factor_store must be auto | f32 | bf16, got {store!r}")
    if store == "bf16" and np.dtype(dtype) == np.float32:
        return "bf16"
    return "f32"


def init_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already honours it and
    nothing is changed. Otherwise the cache goes to ``.jax_cache/`` at the
    root of the checkout (listed in .gitignore): a fixed path, because the
    path is part of the cache key. Returns the directory in use. Called by
    the entry points (CLI mains, bench.py, chip_smoke.py), never by the
    library itself."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


# Environment knob mirroring the reference's compile-time flag system
# (reference: make.inc USE_DEBUG / SPARSE_SOLVER_CHOICE): here a plain env var.
DEBUG = bool(int(os.environ.get("PREALPS_TPU_DEBUG", "0")))
