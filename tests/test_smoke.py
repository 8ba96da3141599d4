"""Smoke tests: every module imports; CLI parsers accept their flags;
miscellaneous combinations exercised nowhere else."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

MODULES = [
    "prealps_tpu",
    "prealps_tpu.api",
    "prealps_tpu.cli",
    "prealps_tpu.config",
    "prealps_tpu.interop",
    "prealps_tpu.native",
    "prealps_tpu.core.io",
    "prealps_tpu.core.scaling",
    "prealps_tpu.core.generators",
    "prealps_tpu.core.partition",
    "prealps_tpu.core.layout",
    "prealps_tpu.ops.formats",
    "prealps_tpu.ops.spmm",
    "prealps_tpu.ops.blockops",
    "prealps_tpu.ops.cholqr",
    "prealps_tpu.ops.tsqr",
    "prealps_tpu.ops.tournament",
    "prealps_tpu.ops.lanczos",
    "prealps_tpu.ops.spmsv",
    "prealps_tpu.ops.doublefloat",
    "prealps_tpu.solvers.ecg",
    "prealps_tpu.solvers.panels",
    "prealps_tpu.solvers.checkpoint",
    "prealps_tpu.precond.api",
    "prealps_tpu.precond.block_jacobi",
    "prealps_tpu.precond.chebyshev",
    "prealps_tpu.precond.lorasc",
    "prealps_tpu.precond.presc",
    "prealps_tpu.precond.twolevel",
    "prealps_tpu.direct.subdomain",
    "prealps_tpu.direct.device_bj",
    "prealps_tpu.parallel.mesh",
    "prealps_tpu.parallel.driver",
    "prealps_tpu.parallel.lorasc_driver",
    "prealps_tpu.utils.timing",
    "prealps_tpu.utils.debug",
]


@pytest.mark.parametrize("mod", MODULES)
def test_imports(mod):
    importlib.import_module(mod)


class TestOptionsValidation:
    def test_bad_options_rejected(self):
        from prealps_tpu.solvers import ECGOptions

        with pytest.raises(ValueError):
            ECGOptions(t=0)
        with pytest.raises(ValueError):
            ECGOptions(maxiter=0)
        with pytest.raises(ValueError):
            ECGOptions(tol=-1.0)
        with pytest.raises(ValueError):
            ECGOptions(variant="bogus")
        with pytest.raises(ValueError):
            ECGOptions(layout="bogus")


class TestStallGuard:
    def test_stall_window_stops_plateau(self, ela_small):
        """A deliberately hopeless solve (identity 'preconditioner', huge
        maxiter, impossible tol) must stop within the stall window instead
        of burning maxiter."""
        from prealps_tpu.ops.formats import csr_to_ell
        from prealps_tpu.ops.spmm import ell_spmm
        from prealps_tpu.core.scaling import sym_rac_scaling
        from prealps_tpu.solvers import ECGOptions, ecg_solve

        a, _ = sym_rac_scaling(ela_small)
        ae = csr_to_ell(a, dtype=np.float32)
        b = jnp.asarray(
            np.random.default_rng(0).standard_normal(a.shape[0]), dtype=jnp.float32
        )
        opts = ECGOptions(t=4, tol=1e-12, maxiter=8000, stall_window=100)
        res = jax.jit(
            lambda bb: ecg_solve(lambda x: ell_spmm(ae, x), None, bb, opts)
        )(b)
        assert int(res.iters) < 8000, "stall guard should cut the plateau"


class TestCheckpointTbn:
    def test_checkpoint_with_lane_major_layout(self, ela_small, tmp_path):
        from prealps_tpu.core.layout import contiguous_row_layout, permute_and_pad_matrix
        from prealps_tpu.core.scaling import sym_rac_scaling
        from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
        from prealps_tpu.ops.spmm import stencil_bsr_spmm_t
        from prealps_tpu.solvers import ECGOptions
        from prealps_tpu.solvers.checkpoint import ecg_solve_checkpointed

        a, d = sym_rac_scaling(ela_small)
        lay = contiguous_row_layout(a.shape[0], 1, row_multiple=24)
        apad = permute_and_pad_matrix(a, lay)
        sb = csr_to_stencil_bsr_t(apad, br=3)
        nrb = lay.n_pad // 3
        b = np.random.default_rng(0).standard_normal(a.shape[0])
        bpad = np.zeros(lay.n_pad)
        bpad[: a.shape[0]] = d * b
        bt = jnp.asarray(np.ascontiguousarray(bpad.reshape(nrb, 3).T))
        opts = ECGOptions(t=4, tol=1e-6, maxiter=2000, layout="tbn")
        res = ecg_solve_checkpointed(
            lambda x: stencil_bsr_spmm_t(sb, x), None, bt, opts,
            str(tmp_path / "tbn.npz"), every=20,
        )
        x = np.asarray(res.x).T.reshape(-1)[: a.shape[0]] * d
        rr = np.linalg.norm(b - ela_small @ x) / np.linalg.norm(b)
        assert rr < 2e-5


class TestExampleScripts:
    def test_weak_scaling_runs(self, capsys):
        import runpy
        import sys

        argv = sys.argv
        try:
            sys.argv = ["weak_scaling.py", "--base-nel", "4",
                        "--shards", "1,2", "--maxiter", "5", "--t", "2"]
            runpy.run_path("examples/weak_scaling.py", run_name="__main__")
        finally:
            sys.argv = argv
        out = capsys.readouterr().out
        assert '"nshards": 1' in out
        assert '"nshards": 2' in out

    def test_graft_entry_points(self):
        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert np.all(np.isfinite(np.asarray(out)))


class TestCliVectorIO:
    """--rhs / --save-sol driver parity (reference: operator.c:136 RHSBuild,
    preAlps_doublevector.c load/save)."""

    def test_rhs_roundtrip(self, tmp_path):
        import numpy as np

        from prealps_tpu.cli import ecg_main
        from prealps_tpu.core.io import load_vector, save_vector

        rng = np.random.default_rng(7)
        n = 3 * 7 * 6 * 5  # elasticity3d(6,5,5) size
        b = rng.standard_normal(n)
        rhs_path = tmp_path / "rhs.txt"
        sol_path = tmp_path / "sol.txt"
        save_vector(str(rhs_path), b)
        np.testing.assert_allclose(load_vector(str(rhs_path)), b, rtol=1e-15)

        rc = ecg_main([
            "--size", "6x5x5", "-e", "2", "--json",
            "--rhs", str(rhs_path), "--save-sol", str(sol_path),
            "-t", "1e-6",
        ])
        assert rc == 0
        x = load_vector(str(sol_path))
        from prealps_tpu.core.generators import elasticity3d

        a = elasticity3d(6, 5, 5)
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-4

    def test_rhs_length_mismatch_errors(self, tmp_path):
        import numpy as np
        import pytest

        from prealps_tpu.cli import ecg_main
        from prealps_tpu.core.io import save_vector

        rhs_path = tmp_path / "rhs.txt"
        save_vector(str(rhs_path), np.ones(10))
        with pytest.raises(SystemExit):
            ecg_main(["--size", "6x5x5", "--rhs", str(rhs_path)])


class TestCliScalableLorasc:
    def test_scalable_flag_runs(self, capsys):
        from prealps_tpu.cli import lorasc_main

        rc = lorasc_main([
            "--generate", "ela", "--size", "6x6x6", "-e", "2",
            "--scalable", "--nparts", "4", "-t", "1e-6", "--json",
        ])
        out = capsys.readouterr().out
        import json

        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["relres"] < 1e-5
        assert rc in (0, None)

    def test_fmt_auto_real_file_lfat5(self, capsys):
        """--fmt auto end-to-end on a REAL MatrixMarket file from the
        reference distribution (not only synthetic families; reference:
        matrix/LFAT5.mtx,
        cplm_matcsr.c:1070 LoadMatrixMarket)."""
        import json
        import os

        import pytest

        from prealps_tpu.cli import ecg_main

        path = "/root/reference/matrix/LFAT5.mtx"
        if not os.path.exists(path):
            pytest.skip("reference matrix dir not available")
        rc = ecg_main([
            "-m", path, "-e", "2", "--fmt", "auto", "-t", "1e-8", "--json",
        ])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc in (0, None)
        assert rec["n"] == 14
        assert rec["relres"] < 1e-7, rec
        # detect_format must have run and reported its choice
        assert rec.get("fmt_chosen") in (
            "stencil", "dia_rcm", "dia", "block_ell_morton",
            "block_ell_natural", "ell"), rec

    def test_fmt_auto_irregular_mtx_file(self, tmp_path, capsys):
        """--fmt auto on an IRREGULAR .mtx written to disk: a
        random-permuted elasticity operator has its grid structure hidden,
        so the cascade must fall through stencil detection and still
        converge on a general format (exercises the Morton/ELL arm of
        ops/formats.py detect_format through the file-loading CLI path)."""
        import json

        import numpy as np
        import scipy.sparse as sp

        from prealps_tpu.cli import ecg_main
        from prealps_tpu.core.generators import elasticity3d
        from prealps_tpu.core.io import save_mtx

        a = elasticity3d(5, 5, 4)
        rng = np.random.default_rng(3)
        perm = rng.permutation(a.shape[0])
        pm = sp.eye(a.shape[0], format="csr")[perm]
        a_shuf = (pm @ a @ pm.T).tocsr()
        path = tmp_path / "irregular.mtx"
        save_mtx(str(path), a_shuf)

        rc = ecg_main([
            "-m", str(path), "-e", "2", "--fmt", "auto", "-t", "1e-8",
            "--json",
        ])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc in (0, None)
        assert rec["n"] == a.shape[0]
        assert rec["relres"] < 1e-7, rec
        assert "fmt_chosen" in rec, rec

    def test_dia_fmt_runs(self, capsys):
        from prealps_tpu.cli import ecg_main

        rc = ecg_main([
            "--generate", "ela", "--size", "6x5x5", "-e", "2",
            "--fmt", "dia", "--nshards", "4", "-t", "1e-7", "--json",
        ])
        out = capsys.readouterr().out
        import json

        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["relres"] < 1e-6
        assert rc in (0, None)


class TestCliPartitionFile:
    """--partition-file / --save-partition (the reference's custom-partition
    workflow, preAlps_utils.c:168-193 + -DMAT_CUSTOM_PARTITIONING_FILE)."""

    def test_partition_roundtrip_ecg(self, tmp_path, capsys):
        import json

        import numpy as np

        from prealps_tpu.cli import ecg_main
        from prealps_tpu.core.io import load_partition

        part_path = tmp_path / "parts.txt"
        # 1st run: auto partition, save it
        rc = ecg_main([
            "--size", "6x5x5", "-e", "2", "--fmt", "ell", "--nshards", "4",
            "-t", "1e-6", "--json", "--save-partition", str(part_path),
        ])
        assert rc in (0, None)
        rec1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        part = load_partition(str(part_path), 3 * 7 * 6 * 5)
        assert part.min() >= 0 and part.max() == 3

        # 2nd run: pinned to the saved partition — same layout, so the
        # deterministic solve must land on the same iteration count
        rc = ecg_main([
            "--size", "6x5x5", "-e", "2", "--fmt", "ell", "--nshards", "4",
            "-t", "1e-6", "--json", "--partition-file", str(part_path),
        ])
        assert rc in (0, None)
        rec2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec2["relres"] < 1e-5
        assert rec2["iters"] == rec1["iters"]

    def test_partition_pinned_lorasc_scalable(self, tmp_path, capsys):
        import json

        import numpy as np

        from prealps_tpu.cli import lorasc_main
        from prealps_tpu.core.io import load_partition

        part_path = tmp_path / "parts.txt"
        rc = lorasc_main([
            "--generate", "ela", "--size", "6x6x6", "-e", "2",
            "--scalable", "--nparts", "4", "-t", "1e-6", "--json",
            "--save-partition", str(part_path),
        ])
        assert rc in (0, None)
        rec1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        part = load_partition(str(part_path), 3 * 7 * 7 * 6)
        assert (part < 0).any(), "separator rows must be marked -1"

        rc = lorasc_main([
            "--generate", "ela", "--size", "6x6x6", "-e", "2",
            "--scalable", "--nparts", "4", "-t", "1e-6", "--json",
            "--partition-file", str(part_path),
        ])
        assert rc in (0, None)
        rec2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec2["relres"] < 1e-5
        assert rec2["iters"] == rec1["iters"]

    def test_partition_file_rejects_bad_length(self, tmp_path):
        import numpy as np
        import pytest

        from prealps_tpu.cli import ecg_main
        from prealps_tpu.core.io import save_partition

        part_path = tmp_path / "parts.txt"
        save_partition(str(part_path), np.zeros(10, dtype=np.int64))
        with pytest.raises((SystemExit, ValueError)):
            ecg_main(["--size", "6x5x5", "--fmt", "ell", "--nshards", "2",
                      "--partition-file", str(part_path)])

    def test_save_partition_under_pre_perm_auto(self, tmp_path, capsys):
        """fmt=auto with a clustering/reordering pre-permutation (at
        nshards>1 detection reaches it via dia_rcm — the Morton probe is
        single-shard only): the saved partition must be in ORIGINAL row
        order (round-4 review fix) so the file is reloadable. The library
        build below asserts pre_perm actually fired so this test can never
        go vacuous."""
        import json

        import numpy as np
        import scipy.sparse as sp

        from prealps_tpu.cli import ecg_main
        from prealps_tpu.core.io import load_partition, save_mtx

        rng = np.random.default_rng(3)
        npts = 608
        pts = rng.random((npts, 3))
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        adj = sp.csr_matrix((d2 < 0.25 ** 2).astype(np.float64))
        adj = adj + adj.T
        a = sp.csr_matrix(
            sp.diags(np.asarray(adj.sum(axis=1)).ravel() + 1.0) - adj)
        pm = rng.permutation(npts)
        a = sp.csr_matrix(a[pm][:, pm])
        mtx = tmp_path / "geo.mtx"
        save_mtx(str(mtx), a)
        part_path = tmp_path / "parts.txt"

        # guard against vacuity: this matrix must take a pre-permutation
        from prealps_tpu.ops.formats import detect_format

        chosen, info = detect_format(a, br=3, nshards=4)
        assert "perm" in info, (chosen, info)

        rc = ecg_main([
            "-m", str(mtx), "-e", "2", "--nshards", "4", "-t", "1e-8",
            "--json", "--save-partition", str(part_path),
        ])
        assert rc in (0, None)
        rec1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec1["relres"] < 1e-6
        part = load_partition(str(part_path), npts)
        assert part.min() >= 0 and part.max() == 3

        # reload: pinned partition (general path) must solve correctly
        rc = ecg_main([
            "-m", str(mtx), "-e", "2", "--nshards", "4", "-t", "1e-8",
            "--json", "--partition-file", str(part_path),
        ])
        assert rc in (0, None)
        rec2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec2["relres"] < 1e-6


class TestWeakScalingScript:
    """Contract of examples/weak_scaling.py: every row must carry the
    comm/compute split fields."""

    def test_rows_carry_comm_split(self):
        import json
        import os
        import subprocess
        import sys as _sys

        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = here
        r = subprocess.run(
            [_sys.executable, os.path.join(here, "examples",
                                           "weak_scaling.py"),
             "--cpu", "--base-nel", "6", "--shards", "1,2", "--maxiter",
             "30"],
            capture_output=True, text=True, timeout=600, env=env, cwd=here,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        rows = [json.loads(ln) for ln in r.stdout.splitlines()
                if ln.strip().startswith("{")]
        assert len(rows) == 2, r.stdout
        for row in rows:
            for key in ("nshards", "iter_ms", "iter_nocoll_ms",
                        "comm_frac", "comm_ms_chain", "comm_frac_chain",
                        "local_ms", "starve_x", "gnnz_per_s"):
                assert key in row, (key, row)
        assert rows[0]["comm_frac"] == 0.0          # single shard: no comm
        assert 0.0 <= rows[1]["comm_frac"] < 1.0    # sane fraction
