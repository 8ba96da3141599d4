"""Mixed-precision iterative refinement around a device solver.

The reference is float64-native via MKL (reference: src/solvers/ecg.c —
all-double arena). On the GPU the fast path is float32; tolerances below the f32
attainable floor are reached by iterative refinement: float64 residuals on
the host, float32 inner solves on device. Shared by all drivers."""

from __future__ import annotations

from typing import Callable

import numpy as np


def refine_solve(
    a_scaled,
    b_eff: np.ndarray,
    inner_solve: Callable[[np.ndarray], tuple[np.ndarray, dict]],
    target_tol: float,
    max_rounds: int = 8,
    stop_ratio: float = 0.9,
):
    """Iterate x += inner_solve(b − A x) until the f64 relative residual of
    the SCALED system meets target_tol, progress stalls (relres > stop_ratio
    × previous — the f32 floor), or max_rounds is hit.

    Returns (x, info) with info aggregating inner iterations and rounds.
    """
    normb = np.linalg.norm(b_eff)
    x = np.zeros_like(b_eff)
    total_iters, rounds = 0, 0
    info: dict = {}
    prev_relres = np.inf
    for _ in range(max_rounds):
        r = b_eff - a_scaled @ x
        relres = np.linalg.norm(r) / normb
        if relres <= target_tol or relres > stop_ratio * prev_relres:
            break
        prev_relres = relres
        dx, info = inner_solve(r)
        x = x + dx
        total_iters += info.get("iters", 0)
        rounds += 1
        if info.get("breakdown"):
            break
    r = b_eff - a_scaled @ x
    info = dict(info or {})
    info["iters"] = total_iters
    info["refine_rounds"] = rounds
    info["res"] = float(np.linalg.norm(r))
    info["relres_scaled"] = float(np.linalg.norm(r) / normb) if normb else 0.0
    return x, info
