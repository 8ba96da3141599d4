#!/usr/bin/env python
"""Smoke run of the ECG solve path on one GPU (or on four with --four).

    python chip_smoke.py          # one card: kernel, bj2l, LORASC, CLI
    python chip_smoke.py --four   # four cards: sharded bj2l + mesh dry run

Drives the library's own entry points at the reference's published size,
Ela400-class 3-D elasticity (elasticity3d(36, 36, 36): n=147,852, nnz≈11.3M,
BASELINE.md), from matrices generated in the repo. Phases run in order in
one process; any failure raises and the exit code is non-zero. Findings go
to stdout line by line; the LAST line is one JSON object

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

printed only when every phase passed. Exits non-zero without that line when
JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

import numpy as np

NEL = 36                      # elasticity3d(36, 36, 36): n = 147,852
GRID = (NEL + 1, NEL + 1, NEL)
T = 12
TOL = 1e-5
ROUND5_BJ2L_ITERS = 130       # f32 headline iteration count of round 5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_device(expect_count: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu",
          f"no GPU: JAX platform is {d.platform!r}")
    check(len(devs) >= expect_count,
          f"need {expect_count} GPUs, JAX sees {len(devs)}")
    # nvidia-smi runs as a child that never imports JAX
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    for line in smi:
        log(f"[device] nvidia-smi: {line.strip()}")

    from prealps_tpu import native
    from prealps_tpu.config import init_compile_cache

    log(f"[device] compile cache: {init_compile_cache()}")
    log(f"[device] native partitioner library available: "
        f"{native.available()}")
    return card


def _headline_matrix():
    from prealps_tpu.core.generators import elasticity3d

    t0 = time.time()
    a = elasticity3d(NEL, NEL, NEL)
    log(f"[matrix] elasticity3d({NEL},{NEL},{NEL}) n={a.shape[0]} "
        f"nnz={a.nnz} ({time.time() - t0:.1f} s)")
    return a


def phase_kernel(a, card: str) -> None:
    """The operator SpMM at t=12, f32, against scipy f64 and against the
    repo's plain XLA form, both at the real width."""
    import jax
    import jax.numpy as jnp

    from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
    from prealps_tpu.ops.spmm import (
        attach_wrap_halo,
        panel_from_lane_major,
        panel_to_lane_major,
        stencil_impl,
        stencil_spmm_ext,
        stencil_spmm_xla_ext,
    )

    st = csr_to_stencil_bsr_t(a, br=3, dtype=np.float32)
    offs = tuple(st.offsets)
    halo = max(abs(o) for o in offs)
    x = np.random.default_rng(1).standard_normal((a.shape[0], T))
    x = x.astype(np.float32)
    xt = panel_to_lane_major(jnp.asarray(x), 3)

    def make(f):
        return jax.jit(lambda b, v: f(b, offs, attach_wrap_halo(v, halo),
                                      halo))

    apply_fn = make(stencil_spmm_ext)
    y = np.asarray(panel_from_lane_major(apply_fn(st.blocks_t, xt)),
                   np.float64)
    x64 = x.astype(np.float64)
    y_ref = a @ x64
    bound = 1e-5 * float(np.abs(abs(a) @ np.abs(x64)).max())
    err = float(np.abs(y - y_ref).max())
    y_xla = np.asarray(panel_from_lane_major(
        make(stencil_spmm_xla_ext)(st.blocks_t, xt)), np.float64)
    err_xla = float(np.abs(y - y_xla).max())
    times = []
    for _ in range(3):
        apply_fn(st.blocks_t, xt).block_until_ready()
    for _ in range(20):
        t0 = time.perf_counter()
        apply_fn(st.blocks_t, xt).block_until_ready()
        times.append(time.perf_counter() - t0)
    log(f"[kernel] stencil SpMM impl={stencil_impl()} n={a.shape[0]} t={T} "
        f"f32: max|y-y_scipy64|={err:.3e} bound 1e-5*max(|A||X|)={bound:.3e}; "
        f"max|y-y_xla|={err_xla:.3e}")
    log(f"[kernel] median of 20 applies {statistics.median(times) * 1e3:.4f} "
        f"ms (min {min(times) * 1e3:.4f}, max {max(times) * 1e3:.4f}) "
        f"on {card}")
    check(err <= bound, f"stencil SpMM error {err:.3e} > {bound:.3e}")
    check(err_xla <= bound, f"kernel vs XLA form {err_xla:.3e} > {bound:.3e}")


def _bj2l(a, nshards: int, dtype):
    from prealps_tpu.parallel.driver import DistributedECG
    from prealps_tpu.solvers import ECGOptions

    t0 = time.time()
    solver = DistributedECG.build(
        a, nshards=nshards,
        opts=ECGOptions(t=T, tol=TOL, variant="odir_fused", layout="tbn"),
        precond="bj2l", fmt="stencil", br=3, grid=GRID, block_size=240,
        dtype=dtype)
    return solver, time.time() - t0


def _solve(solver, a, b):
    t0 = time.time()
    x, info = solver.solve(b)
    t_first = time.time() - t0
    t0 = time.time()
    x, info = solver.solve(b)
    t_warm = time.time() - t0
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    return relres, info, t_first, t_warm


def _peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 2**30:.2f} GiB"


def phase_headline(a, b, card: str) -> None:
    import jax

    solver, t_build = _bj2l(a, 1, np.float32)
    relres, info, t_first, t_warm = _solve(solver, a, b)
    log(f"[bj2l f32] iters={info['iters']} (round-5 f32 count "
        f"{ROUND5_BJ2L_ITERS}) refine_rounds={info.get('refine_rounds')} "
        f"true relres={relres:.3e} build {t_build:.2f} s, first solve "
        f"{t_first:.2f} s, warm solve {t_warm:.4f} s, peak device memory "
        f"{_peak_bytes()} on {card}")
    check(relres < TOL, f"bj2l f32 relres {relres:.3e} >= {TOL}")
    del solver

    jax.config.update("jax_enable_x64", True)
    try:
        solver, t_build = _bj2l(a, 1, np.float64)
        relres, info, t_first, t_warm = _solve(solver, a, b)
        log(f"[bj2l f64] iters={info['iters']} true relres={relres:.3e} "
            f"build {t_build:.2f} s, first solve {t_first:.2f} s, warm "
            f"solve {t_warm:.4f} s on {card}")
        check(relres < TOL, f"bj2l f64 relres {relres:.3e} >= {TOL}")
        del solver
    finally:
        jax.config.update("jax_enable_x64", False)


def phase_lorasc(card: str) -> None:
    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG
    from prealps_tpu.solvers import ECGOptions

    a = elasticity3d(NEL, NEL, NEL, heterogeneous=True)
    b = np.random.default_rng(2).standard_normal(a.shape[0])
    t0 = time.time()
    solver = StencilLorascECG.build(
        a, nparts=8, br=3, grid=GRID,
        opts=ECGOptions(t=T, tol=TOL, variant="omin", layout="tbn"),
        dtype=np.float32, max_deflation=256, inner_tol=1e-3,
        pencil="agg", correction="deflate")
    t_build = time.time() - t0
    relres, info, t_first, t_warm = _solve(solver, a, b)
    pre = solver.precond
    log(f"[lorasc het] iters={info['iters']} deflated_pairs={pre.deflated} "
        f"factor_store={pre.factor_store} true relres={relres:.3e} build "
        f"{t_build:.2f} s, first solve {t_first:.2f} s, warm solve "
        f"{t_warm:.4f} s on {card}")
    log(f"[lorasc het] build stages (s): {json.dumps(pre.timings)}")
    check(relres < TOL, f"LORASC relres {relres:.3e} >= {TOL}")
    check(pre.deflated >= 1, "LORASC deflated no pairs")


def phase_cli() -> None:
    from prealps_tpu.cli import ecg_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ecg_main(["--size", "12x10x10", "-e", "4", "--json"])
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"[cli] prealps-ecg --size 12x10x10 -e 4: {json.dumps(rec)}")
    check(rc == 0 and rec["relres"] < 1e-5,
          f"CLI solve did not reach 1e-5: rc={rc} relres={rec['relres']}")


def phase_four(a, b, card: str) -> None:
    """The sharded paths: bj2l at nshards=4 against nshards=1, and the
    multi-device dry run (ppermute halos, psum, DistributedLorascECG)."""
    import jax

    import __graft_entry__

    res = {}
    for nsh in (1, 4):
        solver, t_build = _bj2l(a, nsh, np.float32)
        if nsh == 4:
            for i, arr in enumerate(jax.tree_util.tree_leaves(
                    solver._operands)):
                devs = sorted(s.device.id for s in arr.addressable_shards)
                check(len(set(devs)) == 4,
                      f"operand {i} is not spread over 4 cards: {devs}")
            log("[four] every operand of the nshards=4 build holds one "
                "shard on each of the 4 cards")
        relres, info, t_first, t_warm = _solve(solver, a, b)
        res[nsh] = info["iters"]
        log(f"[four] bj2l nshards={nsh}: iters={info['iters']} "
            f"refine_rounds={info.get('refine_rounds')} true "
            f"relres={relres:.3e} build {t_build:.2f} s, warm solve "
            f"{t_warm:.4f} s on {card}")
        check(relres < TOL, f"bj2l nshards={nsh} relres {relres:.3e}")
        del solver
    log(f"[four] iterations side by side: nshards=1 {res[1]}, "
        f"nshards=4 {res[4]}")
    __graft_entry__.dryrun_multichip(4)
    log("[four] dryrun_multichip(4) converged on every path")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded paths")
    args = p.parse_args(argv)

    import jax

    card = phase_device(4 if args.four else 1)
    jax.config.update("jax_default_matmul_precision", "highest")
    a = _headline_matrix()
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    if args.four:
        phase_four(a, b, card)
    else:
        phase_kernel(a, card)
        phase_headline(a, b, card)
        phase_lorasc(card)
        phase_cli()
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
