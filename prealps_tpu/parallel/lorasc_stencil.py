"""Single-device ECG + scalable LORASC driver for stencil operators.

The production LORASC path at benchmark scale (reference analog:
examples/test_lorasc.c driving lorasc.c): the ECG loop runs on the
lane-major stencil fast path in ORIGINAL ordering; the preconditioner
(precond/lorasc_scale.py) works in arrow coordinates internally via
node-level gathers. One jitted function per solve; float32 + iterative
refinement on the GPU (config.solve_dtype).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops.formats import rounding_remainder
from prealps_tpu.precond.lorasc_scale import ScalableLorasc, build_scalable_lorasc
from prealps_tpu.solvers.ecg import ECGOptions
from prealps_tpu.solvers.refine import refine_solve


@dataclass
class StencilLorascECG:
    """Build once, solve many. See module docstring."""

    n: int
    br: int
    nrb: int
    opts: ECGOptions
    scale_d: Optional[np.ndarray]
    precond: ScalableLorasc
    _fn: object
    target_tol: float = 0.0
    a_scaled: object = None

    @classmethod
    def build(
        cls,
        a: sp.spmatrix,
        nparts: int = 8,
        br: int = 3,
        grid: tuple[int, int, int] | None = None,
        opts: ECGOptions = ECGOptions(layout="tbn"),
        deflation_tol: float = 1e-2,
        max_deflation: int = 64,
        ncv: int | None = None,
        scale: bool = True,
        dtype=None,
        refine: Optional[bool] = None,
        inner_tol: float = 1e-3,
        shift: float = 0.0,
        pencil: str = "agg",   # "sloc" = scalable PRESC (SSLOC pencil,
                               # reference presc.h:18-21)
        host_refine: bool | None = None,  # f64 host refinement of the
                               # deflation pairs (None = auto: f32 + agg)
        correction: str = "sigma",  # "sigma" (reference E σ Eᵀ form) or
                               # "deflate" (balancing/BNN projection —
                               # f32-robust, see lorasc_scale.lorasc_apply)
        restarts: int = 5,     # thick-restart Lanczos cycles − 1
        node_part=None,        # pinned node partition (part id per node,
                               # -1 = separator; preAlps_utils.c:168-193)
        in_sep=None,
        factor_store: str | None = None,  # banded-factor storage dtype
                               # (None = env/auto; see build_scalable_lorasc)
        a_store: str | None = None,  # operator stencil-block storage dtype
                               # for the SOLVE ("f32" | "bf16"; None = env
                               # PREALPS_A_STORE, default f32). bf16 halves
                               # the A-stream of the iteration SpMM; the
                               # f32 rounding gap is
                               # recovered by the device-resident refinement
                               # via the A_lo = A − bf16(A) correction
                               # operand. The BUILD (interiors, Lanczos,
                               # Sloc) always runs from the f32 blocks.
    ) -> "StencilLorascECG":
        # true-f32 matmuls (TF32 breaks ECG's A-orthonormalisation)
        jax.config.update("jax_default_matmul_precision", "highest")
        if opts.layout != "tbn":
            raise ValueError("StencilLorascECG requires layout='tbn'")
        a = sp.csr_matrix(a)
        dtype = np.dtype(dtype) if dtype is not None else a.dtype
        scale_d = None
        if scale:
            a, scale_d = sym_rac_scaling(a)
        target_tol = opts.tol
        if refine is None:
            refine = dtype == np.float32 and opts.tol < inner_tol
        if refine:
            from dataclasses import replace as _dc_replace

            opts = _dc_replace(
                opts, tol=inner_tol, stall_window=opts.stall_window or 250
            )

        from prealps_tpu.ops.formats import csr_to_stencil_bsr_t

        a_t = csr_to_stencil_bsr_t(a, br=br, dtype=dtype)
        if a_t is None:
            raise ValueError(
                "matrix is not stencil-structured; use DistributedLorascECG"
            )
        precond = build_scalable_lorasc(
            a, nparts=nparts, br=br, grid=grid,
            deflation_tol=deflation_tol, max_deflation=max_deflation,
            ncv=ncv, dtype=dtype, shift=shift, a_stencil=a_t,
            pencil=pencil, host_refine=host_refine, correction=correction,
            restarts=restarts, node_part=node_part, in_sep=in_sep,
            factor_store=factor_store,
        )
        a_store = (a_store or os.environ.get("PREALPS_A_STORE", "f32"))
        if a_store not in ("f32", "bf16", "bf16_all"):
            # same contract as factor_store: a typo must not silently run
            # the full-precision path while claiming a reduced one
            raise ValueError(
                f"a_store must be f32 | bf16 | bf16_all, got {a_store!r}")
        if a_store in ("bf16", "bf16_all") and np.dtype(dtype) == np.float32:
            # "bf16": bf16 blocks for the PRECONDITIONER's embedded sweep
            # SpMMs only (lorasc_apply streams A twice per apply — Agi·zi
            # forward, Aig·zg backward — vs the iteration's once, so this
            # covers ~2/3 of the solve's A traffic). A preconditioner-side
            # perturbation only: M changes by a fixed 4e-3, the ITERATION
            # still solves the exact f32 system.
            # "bf16_all": the iteration operator too — REJECTED as default
            # (measured: bf16(A) is INDEFINITE at this problem's κ — an
            # elementwise 4e-3 perturbation exceeds λ_min of the scaled
            # operator — and CG breaks down at iteration 1; the bf16
            # factor/BJ stores survive because LOCAL blocks are
            # well-conditioned). Kept for measurement.
            from prealps_tpu.ops.formats import StencilBsrTMatrix

            a_bf = StencilBsrTMatrix(
                blocks_t=a_t.blocks_t.astype(jnp.bfloat16),
                offsets=a_t.offsets, shape=a_t.shape)
            if a_store == "bf16_all":
                precond.operands["a_stencil"] = a_bf
            else:
                precond.operands["a_stencil_m"] = a_bf
        if a_store == "bf16_all":
            import ml_dtypes

            store_np = ml_dtypes.bfloat16
        else:
            store_np = np.float32
        if refine and np.dtype(dtype) == np.float32:
            # lo half of the f64→store operator rounding, A = A_st + A_lo:
            # the device-resident refinement's residual floor is set by the
            # matrix storage, not the df vector pair — without this term the
            # device rnorm reads ~6e-8·‖A‖·‖x‖/‖b‖ (f32 store; ~4e-3 bf16)
            # BELOW the true residual (measured ≈1e-5 on het elasticity,
            # i.e. AT the target tol).
            precond.operands["a_lo_blocks"] = rounding_remainder(
                a, a_t, store_dtype=store_np)

        n = a.shape[0]
        nrb = n // br

        fn = _compile_ecg_fns_cached(precond.plan, opts, n, br)
        obj = cls(
            n=n, br=br, nrb=nrb, opts=opts, scale_d=scale_d, precond=precond,
            _fn=fn, target_tol=target_tol, a_scaled=a if refine else None,
        )
        obj._m_ops = precond.operands
        return obj

    def with_tol(self, tol: float, inner_tol: float = 1e-3,
                 refine: Optional[bool] = None) -> "StencilLorascECG":
        """A solver at a different target tolerance SHARING this built
        preconditioner (the LORASC build is tolerance-independent; only the
        ECG loop needs re-tracing). The BASELINE.md deep-tolerance record
        rides this instead of paying a second build."""
        from dataclasses import replace as _dc_replace

        dtype = np.asarray(self.precond.operands["sep_mask"]).dtype
        if refine is None:
            refine = dtype == np.float32 and tol < inner_tol
        if refine and self.a_scaled is None:
            raise ValueError("refined with_tol() needs a_scaled from a "
                             "refined original build")
        opts = _dc_replace(
            self.opts, tol=inner_tol if refine else tol,
            stall_window=self.opts.stall_window or (250 if refine else 0),
        )
        fn = _compile_ecg_fns_cached(self.precond.plan, opts, self.n,
                                     self.br)
        obj = StencilLorascECG(
            n=self.n, br=self.br, nrb=self.nrb, opts=opts,
            scale_d=self.scale_d, precond=self.precond, _fn=fn,
            target_tol=tol, a_scaled=self.a_scaled if refine else None,
        )
        obj._m_ops = self.precond.operands
        return obj

    def _solve_scaled_once(self, b_eff: np.ndarray):
        # (jitted fns built by _compile_ecg_fns below)
        from prealps_tpu.solvers.ecg import ecg_finalize

        init, step, _ = self._fn
        opts = self.opts
        dtype = np.asarray(self.precond.operands["sep_mask"]).dtype
        b_lane = np.ascontiguousarray(
            b_eff.astype(dtype).reshape(self.nrb, self.br).T
        )
        state, normb = init(jnp.asarray(b_lane), self._m_ops)
        normb_f = float(normb)
        tol_abs = opts.tol * normb_f
        prev_it = -1
        while True:
            state, flags = step(state, normb, self._m_ops)
            it, res_now, brk, bs, stall = np.asarray(flags)
            it = int(it)
            if (res_now <= tol_abs or it >= opts.maxiter or brk or bs <= 0
                    or (opts.stall_window > 0 and stall >= opts.stall_window)
                    or it == prev_it):
                break
            prev_it = it
        res = ecg_finalize(state, normb, opts.layout)
        # scalars come from the already-fetched chunk flags — every extra
        # device fetch synchronises host and device
        x = np.ascontiguousarray(np.asarray(res.x).T).reshape(-1)
        info = {
            "iters": it, "res": float(res_now),
            "normb": normb_f, "breakdown": bool(brk),
            "deflated": self.precond.deflated,
        }
        return x.astype(np.float64), info

    def _solve_refined_device(self, b_eff: np.ndarray,
                              max_refine_rounds: int = 8):
        """Mixed-precision refinement with DEVICE-RESIDENT state: x and the
        df residual stay on device across rounds; per round the host sees
        only the chunk flags and one 4-scalar pack (vs two panel transfers
        + a host f64 matvec per round in the host loop). A final host-f64
        cross-check keeps the honesty contract; on a shortfall (a compiler
        that contracts a*b+c to fma degrades the df transforms —
        parallel/driver.py local_refine) the caller finishes with host
        rounds."""
        init, step, finish = self._fn
        opts = self.opts

        normb0 = float(np.linalg.norm(b_eff))
        # keep the uploaded rhs resident across repeat solves of the same b
        # (warm + timed bench runs), like the driver path
        key = hash(b_eff.tobytes())
        if getattr(self, "_b2_key", None) != key:
            b_pad = np.ascontiguousarray(
                b_eff.reshape(self.nrb, self.br).T)      # (br, nrb) f64
            b_hi = b_pad.astype(np.float32)
            b_lo = (b_pad - b_hi.astype(np.float64)).astype(np.float32)
            self._b2_dev = jax.device_put(jnp.asarray(np.stack([b_hi, b_lo])))
            self._b2_key = key
        b2 = self._b2_dev
        x2 = jnp.zeros_like(b2)
        r2 = b2
        rnorm = normb0
        prev_relres = np.inf
        total_iters, rounds = 0, 0
        breakdown = False
        for _ in range(max_refine_rounds):
            relres = rnorm / normb0 if normb0 else 0.0
            if relres <= self.target_tol or relres > 0.9 * prev_relres:
                break
            prev_relres = relres
            state, normb_dev = init(r2[0], self._m_ops)
            tol_abs = opts.tol * rnorm
            prev_it = -1
            while True:
                state, flags = step(state, normb_dev, self._m_ops)
                # SPECULATIVE finish: dispatches are async — only fetches
                # synchronise — so dispatch the round's closing glue now
                # and fetch its scalar pack TOGETHER with the chunk flags
                # (one sync per round instead of two; wasted work only when
                # a round needs more than one PREALPS_LORASC_CHUNK-iteration
                # chunk)
                x2_f, r2_f, scal = finish(state, normb_dev, x2, b2,
                                          self._m_ops)
                fl, sc = jax.device_get((flags, scal))
                it, res_now, brk, bs, stall = np.asarray(fl)
                it = int(it)
                if (res_now <= tol_abs or it >= opts.maxiter or brk
                        or bs <= 0 or it == prev_it
                        or (opts.stall_window > 0
                            and stall >= opts.stall_window)):
                    break
                prev_it = it
            x2, r2 = x2_f, r2_f
            it_r, brk_f, _bs, rnorm = np.asarray(sc)
            rnorm = float(rnorm)
            total_iters += int(it_r)
            rounds += 1
            if os.environ.get("PREALPS_REFINE_DEBUG"):
                print(f"[refine] round={rounds} it={int(it_r)} "
                      f"rnorm={rnorm:.3e} relres={rnorm / normb0:.3e}",
                      flush=True)
            if brk_f:
                breakdown = True
                break
        # ONE x fetch of BOTH df halves. A hi-only fetch (6e-8 relative
        # representation error) is NOT enough even at tol=1e-5 on the het
        # problem: ‖x‖/‖b‖ is large there, so the dropped lo half showed up
        # as true relres ≈ 1e-5 and silently triggered two host polish
        # rounds (measured: 125 vs 65 iters).
        x_np = np.asarray(x2).astype(np.float64)
        x_np = x_np[0] + x_np[1]
        x = np.ascontiguousarray(x_np.T).reshape(-1)
        r = b_eff - self.a_scaled @ x        # host f64 cross-check
        info = {
            "iters": total_iters, "res": float(np.linalg.norm(r)),
            "normb": normb0, "breakdown": breakdown,
            "refine_rounds": rounds,
            "relres_scaled": float(np.linalg.norm(r) / normb0)
            if normb0 else 0.0,
            "deflated": self.precond.deflated,
        }
        return x, info

    def solve(self, b: np.ndarray, max_refine_rounds: int = 8):
        b = np.asarray(b)
        b_eff = self.scale_d * b if self.scale_d is not None else b.astype(np.float64)
        if self.a_scaled is None:
            x, info = self._solve_scaled_once(b_eff)
        else:
            x, info = None, None
            if not bool(int(os.environ.get("PREALPS_HOST_REFINE", "0"))):
                x, info = self._solve_refined_device(
                    b_eff, max_refine_rounds=max_refine_rounds)
            if (x is None
                    or (info["relres_scaled"] > self.target_tol
                        and not info["breakdown"])):
                # host-loop fallback (or polish after a device-df shortfall)
                x0 = x
                base_iters = info["iters"] if info else 0
                base_rounds = info.get("refine_rounds", 0) if info else 0

                def _inner(r):
                    return self._solve_scaled_once(r)

                if x0 is None:
                    x, info = refine_solve(
                        self.a_scaled, b_eff, _inner, self.target_tol,
                        max_rounds=max_refine_rounds)
                else:
                    normb = np.linalg.norm(b_eff)
                    x = x0
                    brk = False
                    for _ in range(max_refine_rounds - base_rounds):
                        r = b_eff - self.a_scaled @ x
                        relres = np.linalg.norm(r) / normb if normb else 0.0
                        if relres <= self.target_tol:
                            break
                        dx, inf_r = self._solve_scaled_once(r)
                        x = x + dx
                        base_iters += inf_r.get("iters", 0)
                        base_rounds += 1
                        if inf_r.get("breakdown"):
                            brk = True
                            break
                    r = b_eff - self.a_scaled @ x
                    info = {
                        "iters": base_iters,
                        "res": float(np.linalg.norm(r)),
                        "normb": float(normb), "breakdown": brk,
                        "refine_rounds": base_rounds,
                        "relres_scaled": float(np.linalg.norm(r) / normb)
                        if normb else 0.0,
                    }
            info["deflated"] = self.precond.deflated
        if self.scale_d is not None:
            x = self.scale_d * x
        return x, info


def _compile_ecg_fns_cached(plan, opts: ECGOptions, n: int, br: int):
    """Solve-fn cache across builds/with_tol clones (same rationale and
    shared store as lorasc_scale._LANCZOS_FN_CACHE: per-build jit
    re-creation re-lowers the program; the shared key helper also carries
    the trace-time env knobs)."""
    from prealps_tpu.precond.lorasc_scale import _fn_cache_get, _lanczos_fn_key

    key = (_lanczos_fn_key(plan, "ecg_fns", 0, 0, 0, 0, 0, "x")
           + repr((repr(opts), n, br,
                   os.environ.get("PREALPS_LORASC_CHUNK", "400"))))
    return _fn_cache_get(key, lambda: _compile_ecg_fns(plan, opts, n, br))


def _compile_ecg_fns(plan, opts: ECGOptions, n: int, br: int):
    """Jitted (init, step) for the chunked ECG loop over the stencil fast
    path with the scalable-LORASC apply.

    Operands go in as jit ARGUMENTS — closing over them would embed the
    multi-GB factor arrays as constants in the lowered module. The solve
    runs in CHUNKS of bounded device dispatches (PREALPS_LORASC_CHUNK
    iterations) with a scalars-only host sync between them, which gives
    live iteration progress."""
    import jax.numpy as jnp

    from prealps_tpu.ops.spmm import stencil_bsr_spmm_t
    from prealps_tpu.precond.lorasc_scale import lorasc_apply
    from prealps_tpu.solvers.ecg import ecg_init, ecg_run

    nrb = n // br
    t = opts.t
    r_idx = jnp.arange(nrb)[None, :]
    k_idx = jnp.arange(br)[:, None]
    grow = r_idx * br + k_idx
    assign = ((grow * t) // n).astype(jnp.int32)
    chunk = int(os.environ.get("PREALPS_LORASC_CHUNK", "400"))

    def _aap(m_ops):
        return lambda x: stencil_bsr_spmm_t(m_ops["a_stencil"], x)

    def _map(m_ops):
        return lambda r: lorasc_apply(plan, m_ops, r)

    def init(b, m_ops):
        return ecg_init(_aap(m_ops), _map(m_ops), b, opts,
                        split_assign=assign)

    def step(s, nb, m_ops):
        s = ecg_run(_aap(m_ops), _map(m_ops), s, nb, opts,
                    max_steps=chunk)
        return s, jnp.stack([
            s.it.astype(jnp.float32), s.res.astype(jnp.float32),
            s.breakdown.astype(jnp.float32),
            jnp.sum(s.mask).astype(jnp.float32),
            s.stall.astype(jnp.float32),
        ])

    def finish(s, nb, x2, b2, m_ops):
        """End-of-round glue, entirely on device: fold the round's correction
        into the double-float solution, recompute the df residual, and pack
        the host-needed scalars into ONE fetchable vector. The host loop in
        the host loop pays two panel transfers + a host f64 matvec per
        refinement round; here only this scalar pack and the final x cross
        to the host. Residual precision: A·x_hi in compensated double-float
        (stencil_spmm_df_ext) + A·x_lo in f32 — the same ~48-mantissa-bit
        argument as parallel/driver.py local_refine."""
        from prealps_tpu.ops.doublefloat import df_add
        from prealps_tpu.ops.spmm import (
            attach_wrap_halo,
            stencil_spmm_df_ext,
            stencil_spmm_ext,
        )

        from prealps_tpu.solvers.ecg import ecg_finalize

        res = ecg_finalize(s, nb, opts.layout)
        xh, xl = df_add((x2[0], x2[1]),
                        (res.x, jnp.zeros_like(res.x)))
        a_t = m_ops["a_stencil"]
        halo = max(max(abs(o) for o in a_t.offsets), 0)
        x_ext = attach_wrap_halo(xh[None], halo)
        yh, yl = stencil_spmm_df_ext(
            a_t.blocks_t, a_t.offsets, x_ext, halo)
        y2 = stencil_bsr_spmm_t(a_t, xl[None])
        rh, rl = df_add((b2[0][None], b2[1][None]), (-yh, -yl))
        rh, rl = df_add((rh, rl), (-y2, jnp.zeros_like(y2)))
        if "a_lo_blocks" in m_ops:
            # matrix-rounding correction A_lo·x_hi (rounding_remainder)
            y3 = stencil_spmm_ext(
                m_ops["a_lo_blocks"], a_t.offsets, x_ext, halo)
            rh, rl = df_add((rh, rl), (-y3, jnp.zeros_like(y3)))
        rnorm = jnp.sqrt(jnp.sum(rh[0].astype(jnp.float32) ** 2))
        scal = jnp.stack([
            s.it.astype(jnp.float32),
            res.breakdown.astype(jnp.float32),
            jnp.sum(s.mask).astype(jnp.float32),
            rnorm,
        ])
        return jnp.stack([xh, xl]), jnp.stack([rh[0], rl[0]]), scal

    return (jax.jit(init), jax.jit(step), jax.jit(finish))
