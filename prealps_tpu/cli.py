"""Command-line drivers mirroring the reference's example binaries.

(reference: examples/test_ecg_prealps_op.c getopt flags -m matrix -e enlarging
factor -o ortho alg -r adaptive reduction -t tol -i maxiter; test_lorasc.c
-p precond -npLevel1.) Entry points are installed as prealps-ecg /
prealps-lorasc / prealps-bench (pyproject.toml).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _resolve_layout(args):
    """Default layout from the platform policy (config.panel_layout)."""
    if args.layout is not None:
        return args.layout
    if args.fmt == "auto":
        return "nt"   # the driver re-resolves layout to match the detected fmt
    from prealps_tpu.config import panel_layout

    return panel_layout(args.fmt, getattr(args, "precond", None))


def _load_matrix(args):
    import os

    from prealps_tpu.core.generators import elasticity3d, poisson3d
    from prealps_tpu.core.io import load_mtx

    if args.matrix:
        if not os.path.exists(args.matrix):
            raise SystemExit(f"error: matrix file not found: {args.matrix}")
        return load_mtx(args.matrix)
    try:
        nx, ny, nz = (int(v) for v in args.size.split("x"))
    except ValueError:
        raise SystemExit(
            f"error: --size must look like 12x10x10, got {args.size!r}"
        )
    gen = elasticity3d if args.generate.startswith("ela") else poisson3d
    return gen(nx, ny, nz)


def _load_rhs(args, n):
    """rhs from --rhs file or random (reference drivers seed srand and
    generate when no file is given, test_ecg_prealps_op.c:174)."""
    if getattr(args, "rhs", None):
        from prealps_tpu.core.io import load_vector

        b = load_vector(args.rhs)
        if b.shape[0] != n:
            raise SystemExit(
                f"error: rhs length {b.shape[0]} != matrix size {n}"
            )
        return b
    rng = np.random.default_rng(args.seed)
    return rng.standard_normal(n)


def _maybe_save_sol(args, x):
    if getattr(args, "save_sol", None):
        from prealps_tpu.core.io import save_vector

        save_vector(args.save_sol, x)


def _common_parser(desc):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("-m", "--matrix", help="MatrixMarket file (.mtx)")
    p.add_argument("--generate", default="ela", choices=["ela", "poisson"],
                   help="generated problem family when no matrix is given")
    p.add_argument("--size", default="12x10x10", help="elements per dim, e.g. 12x10x10")
    p.add_argument("-e", "--enlarging-factor", type=int, default=4, dest="t")
    p.add_argument("-o", "--ortho-alg", default="odir_fused",
                   choices=["omin", "odir", "odir_fused"])
    p.add_argument("-r", "--adaptive", action="store_true",
                   help="dynamic search-direction reduction (ADAPT_BS)")
    p.add_argument("--adaptive-mode", default="truncate",
                   choices=["truncate", "freeze"], dest="adaptive_mode",
                   help="truncate = the reference's -r 1 semantics "
                        "(ecg.c:485-496); freeze = keep dropped directions "
                        "as a frozen basis (converges where the reference "
                        "heuristic stalls)")
    p.add_argument("-t", "--tol", type=float, default=1e-5)
    p.add_argument("-i", "--maxiter", type=int, default=10000)
    p.add_argument("--nshards", type=int, default=1)
    p.add_argument("--fmt", default="auto",
                   choices=["auto", "ell", "dia", "stencil", "block_ell"],
                   help="matrix storage format; auto (default) detects the "
                        "fastest structure (stencil → DIA → Morton-clustered "
                        "block-ELL → ELL) and logs the choice")
    p.add_argument("--layout", default=None, choices=[None, "nt", "tbn"],
                   help="panel layout (tbn = lane-major stencil path; "
                        "default: tbn on the GPU for stencil/dia, nt "
                        "otherwise)")
    p.add_argument("--dtype", default=None, choices=[None, "f32", "f64"],
                   help="working precision (default: f32 + refinement on "
                        "the GPU, f64 on the CPU)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rhs", help="right-hand-side vector file (one value per "
                   "line, '%%' comments; reference: operator.c:136 RHSBuild "
                   "loads rhs files) — default: random with --seed")
    p.add_argument("--save-sol", help="write the solution vector to this file")
    p.add_argument("--partition-file", dest="partition_file",
                   help="pinned row partition (one part id per row, '%%' "
                        "comments; -1 marks separator rows for LORASC) — "
                        "the reference's custom-partitioning-file workflow "
                        "(preAlps_utils.c:168-193)")
    p.add_argument("--save-partition", dest="save_partition",
                   help="write the partition actually used to this file "
                        "(reloadable via --partition-file)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print the residual history (iteration monitor)")
    return p


def _dtype_of(args):
    """Resolve the run dtype from the platform policy (config.solve_dtype),
    which also enables x64 when the answer is f64."""
    from prealps_tpu.config import solve_dtype

    return solve_dtype(args.dtype)


def _report(args, a, b, x, info, wall):
    _maybe_save_sol(args, x)
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    out = {
        "n": a.shape[0], "nnz": a.nnz, "iters": info["iters"],
        "relres": relres, "wall_s": round(wall, 4),
    }
    out.update({k: info[k] for k in ("bs", "breakdown", "refine_rounds",
                                     "fmt_chosen") if k in info})
    if args.json:
        print(json.dumps(out))
    else:
        if getattr(args, "verbose", False) and "history" in info:
            h = info["history"]
            h = h[h >= 0]
            step = max(1, len(h) // 50)
            for i in range(0, len(h), step):
                print(f"Iteration: {i:5d}  res: {h[i]:.6e}")
        for k, v in out.items():
            print(f"{k:>12}: {v}")
    return 0 if relres < 100 * args.tol else 1


def ecg_main(argv=None):
    """ECG + block Jacobi (reference: examples/test_ecg_prealps_op.c)."""
    p = _common_parser("Enlarged CG with block-Jacobi preconditioning")
    p.add_argument("--nblocks-per-shard", type=int, default=1)
    p.add_argument("--precond", default="block_jacobi",
                   choices=["block_jacobi", "bj2l", "chebyshev", "none"],
                   help="bj2l = block Jacobi + geometric-RBM two-level "
                        "coarse space (generated grids, fmt=stencil, "
                        "layout=tbn)")
    args = p.parse_args(argv)

    from prealps_tpu.config import init_compile_cache
    from prealps_tpu.parallel.driver import DistributedECG
    from prealps_tpu.solvers import ECGOptions

    init_compile_cache()

    a = _load_matrix(args)
    b = _load_rhs(args, a.shape[0])
    opts = ECGOptions(t=args.t, tol=args.tol, maxiter=args.maxiter,
                      variant=args.ortho_alg, adaptive=args.adaptive,
                      adaptive_mode=args.adaptive_mode,
                      layout=_resolve_layout(args))
    kwargs = {}
    if args.precond == "bj2l":
        if args.matrix or not args.generate.startswith("ela"):
            raise SystemExit("error: --precond bj2l needs a generated "
                             "elasticity grid (--generate ela --size ...)")
        nx, ny, nz = (int(v) for v in args.size.split("x"))
        kwargs["grid"] = (nx + 1, ny + 1, nz)   # node dims (generators.py)
    parts = None
    if args.partition_file:
        from prealps_tpu.core.io import load_partition

        parts = load_partition(args.partition_file, a.shape[0])
    solver = DistributedECG.build(
        a, nshards=args.nshards, opts=opts, precond=args.precond,
        nblocks_per_shard=args.nblocks_per_shard, dtype=_dtype_of(args),
        fmt=args.fmt, parts=parts, auto_layout=args.layout is None,
        **kwargs,
    )
    if args.save_partition:
        from prealps_tpu.core.io import save_partition

        lay = solver.layout
        part = lay.inv_perm // lay.rows_per_shard
        if solver.pre_perm is not None:
            # fmt=auto applied a clustering permutation; map the partition
            # back to ORIGINAL row order so the file is reloadable
            part_orig = np.empty_like(part)
            part_orig[solver.pre_perm] = part
            part = part_orig
        save_partition(args.save_partition, part)
    t0 = time.time()
    x, info = solver.solve(b)
    if solver.fmt_info is not None:
        # surface the fmt=auto detection outcome (ops/formats.py cascade)
        info = dict(info)
        info["fmt_chosen"] = solver.fmt_info.get("chosen")
    return _report(args, a, b, x, info, time.time() - t0)


def lorasc_main(argv=None):
    """ECG + LORASC / PRESC (reference: examples/test_lorasc.c, test_presc.c)."""
    p = _common_parser("Enlarged CG with LORASC/PRESC Schur preconditioning")
    p.add_argument("-p", "--precond", default="lorasc", choices=["lorasc", "presc"])
    p.add_argument("--nparts", type=int, default=8,
                   help="subdomain count (single-device build)")
    p.add_argument("--np-level1", type=int, default=0, dest="np_level1",
                   help="distributed 2-level mesh: number of level-1 groups; "
                   "the mesh is (np_level1, nshards // np_level1) — the "
                   "reference's -npLevel1 masterLevel/localLevel split "
                   "(test_lorasc.c:223-236). Requires --nshards > 1.")
    p.add_argument("--deflation-tol", type=float, default=1e-2)
    p.add_argument("--eig-method", default="direct", choices=["direct", "lanczos"])
    p.add_argument("--eigs-kind", default="ssloc", choices=["ssloc", "saloc"])
    p.add_argument("--scalable", action="store_true",
                   help="at-scale banded LORASC for stencil operators "
                   "(block-banded interiors + thick-restart Lanczos "
                   "deflation; precond/lorasc_scale.py — the benchmark path)")
    p.add_argument("--pencil", default="agg", choices=["agg", "sloc", "saloc"],
                   help="deflation pencil for --scalable: agg = LORASC "
                   "(S u = λ Agg u, lorasc_eigsolve.c), sloc = PRESC SSLOC "
                   "(S u = λ Sloc u with exact local Schur complements, "
                   "presc.h:18-21 + presc.c:239-241)")
    p.add_argument("--max-deflation", type=int, default=64)
    p.add_argument("--correction", default="sigma",
                   choices=["sigma", "deflate"],
                   help="low-rank correction form (--scalable and "
                   "distributed builds): sigma = reference E σ Eᵀ "
                   "(lorasc_eigsolve.c:247); deflate = balancing/BNN "
                   "projection over the harmonic lift — f32-robust, pair "
                   "with -o omin on high-contrast problems")
    p.add_argument("--factor-store", default=None,
                   choices=[None, "auto", "f32", "bf16"],
                   help="storage dtype of the banded factors the apply "
                   "streams (--scalable path): auto (default) = f32; bf16 "
                   "halves the stream of f32 builds")
    args = p.parse_args(argv)

    from prealps_tpu.api import ECGSolver
    from prealps_tpu.config import init_compile_cache
    from prealps_tpu.solvers import ECGOptions

    init_compile_cache()

    a = _load_matrix(args)
    b = _load_rhs(args, a.shape[0])
    opts = ECGOptions(t=args.t, tol=args.tol, maxiter=args.maxiter,
                      variant=args.ortho_alg, adaptive=args.adaptive,
                      adaptive_mode=args.adaptive_mode)
    node_part = None
    if ((args.partition_file or args.save_partition)
            and not (args.precond == "lorasc" and args.scalable)):
        raise SystemExit("error: --partition-file/--save-partition are "
                         "supported on the --scalable LORASC path "
                         "(and prealps-ecg)")
    if args.partition_file:
        from prealps_tpu.core.io import load_partition

        rowpart = load_partition(args.partition_file, a.shape[0])
        br = 3
        if a.shape[0] % br:
            raise SystemExit("error: matrix size is not divisible by the "
                             "3-dof node block")
        rp = rowpart.reshape(-1, br)
        if not np.all(rp == rp[:, :1]):
            raise SystemExit("error: partition must be constant within "
                             "each 3-dof node block")
        node_part = rp[:, 0]
    if args.precond == "lorasc" and args.scalable:
        from dataclasses import replace as _dc_replace

        from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG

        solver = StencilLorascECG.build(
            a, nparts=args.nparts, opts=_dc_replace(opts, layout="tbn"),
            deflation_tol=args.deflation_tol,
            max_deflation=args.max_deflation, dtype=_dtype_of(args),
            pencil=args.pencil, correction=args.correction,
            node_part=node_part, factor_store=args.factor_store,
        )
        if args.save_partition:
            from prealps_tpu.core.io import save_partition

            save_partition(args.save_partition,
                           np.repeat(solver.precond.plan.part_arr, 3))
    elif args.precond == "lorasc" and (args.nshards > 1 or args.np_level1):
        from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG

        if args.np_level1:
            nsh = args.nshards if args.nshards > 1 else args.np_level1
            if nsh % args.np_level1:
                raise SystemExit("error: --np-level1 must divide --nshards")
            mesh_shape = (args.np_level1, nsh // args.np_level1)
        else:
            mesh_shape = None
        solver = DistributedLorascECG.build(
            a, nshards=args.nshards, opts=opts, mesh_shape=mesh_shape,
            deflation_tol=args.deflation_tol, dtype=_dtype_of(args),
            correction=args.correction,
        )
    else:
        if args.correction == "deflate":
            raise SystemExit(
                "error: --correction deflate requires --scalable or a "
                "distributed build (--nshards/--np-level1); the small-scale "
                "path implements the sigma form only")
        kwargs = dict(nparts=args.nparts, deflation_tol=args.deflation_tol,
                      dtype=_dtype_of(args))
        if args.precond == "lorasc":
            kwargs["eig_method"] = args.eig_method
        else:
            kwargs["eigs_kind"] = args.eigs_kind
        solver = ECGSolver.build(a, opts=opts, precond=args.precond, **kwargs)
    t0 = time.time()
    x, info = solver.solve(b)
    return _report(args, a, b, x, info, time.time() - t0)


def bench_main(argv=None):
    """Benchmark wrapper (see bench.py at the repo root)."""
    import argparse
    import os
    import runpy

    p = argparse.ArgumentParser(
        prog="prealps-bench",
        description="Run the headline benchmark suite (bench.py): compact "
                    "one-line-per-metric scoreboard on stdout, full records "
                    "on stderr.",
        epilog="Knobs (env): PREALPS_BENCH_FAST=1 headline only; "
               "PREALPS_BENCH_SKIP_HET / _SKIP_PRESC / _SKIP_IRR skip "
               "sections; PREALPS_BENCH_NEL/T/TOL/BJ/PRECOND/HET/FMT "
               "select the configuration; PREALPS_BENCH_CPU=1 rehearses "
               "on the CPU.")
    p.add_argument("--fast", action="store_true",
                   help="headline record only (PREALPS_BENCH_FAST=1)")
    args = p.parse_args(argv)
    if args.fast:
        os.environ["PREALPS_BENCH_FAST"] = "1"

    # bench.py lives at the repo root, one level above the package — resolve
    # relative to the package so the installed entry point works from any CWD
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench_path = os.path.join(pkg_root, "bench.py")
    if not os.path.exists(bench_path):
        bench_path = "bench.py"  # source checkout fallback
    sys.argv = [bench_path]
    runpy.run_path(bench_path, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(ecg_main())
