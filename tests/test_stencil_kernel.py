"""The stencil SpMM as the product path runs it, and the platform policy.

The Triton kernel runs here in Pallas interpret mode against scipy; the
choice of kernel, the dtype/layout/factor-store policy and the compile
cache are checked for the CPU and for a mocked GPU.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
from prealps_tpu.ops.spmm import (
    attach_wrap_halo,
    panel_from_lane_major,
    panel_to_lane_major,
    stencil_spmm_triton_ext,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _triton(a, br, x, chunk=64, dtype=np.float64, blocks_dtype=None):
    st = csr_to_stencil_bsr_t(a, br=br, dtype=dtype)
    blocks = st.blocks_t if blocks_dtype is None else \
        st.blocks_t.astype(blocks_dtype)
    halo = max(abs(o) for o in st.offsets)
    xt = panel_to_lane_major(jnp.asarray(x.astype(dtype)), br)
    y = stencil_spmm_triton_ext(blocks, tuple(st.offsets),
                                attach_wrap_halo(xt, halo), halo,
                                chunk=chunk, interpret=True)
    return np.asarray(panel_from_lane_major(y))


@pytest.fixture()
def mock_gpu(monkeypatch):
    """Make the platform policy see a GPU (jax.default_backend() == 'gpu')."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


class TestTritonStencil:
    @pytest.mark.parametrize("chunk", [64, 128])
    def test_br3_matches_scipy(self, ela_small, rng, chunk):
        x = rng.standard_normal((ela_small.shape[0], 4))
        y = _triton(ela_small, 3, x, chunk=chunk)
        np.testing.assert_allclose(y, ela_small @ x, rtol=1e-12, atol=1e-12)

    def test_br1_dia_form(self, poisson_small, rng):
        x = rng.standard_normal((poisson_small.shape[0], 2))
        y = _triton(poisson_small, 1, x)
        np.testing.assert_allclose(y, poisson_small @ x, rtol=1e-12,
                                   atol=1e-12)

    def test_nodes_not_divisible_by_chunk(self, rng):
        from prealps_tpu.core.generators import poisson3d

        a = poisson3d(7, 5, 5)           # 175 nodes, chunk 64
        x = rng.standard_normal((a.shape[0], 3))
        np.testing.assert_allclose(_triton(a, 1, x, chunk=64), a @ x,
                                   rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("t", [12, 20])
    def test_t_not_a_power_of_two(self, ela_small, rng, t):
        """t=12 pads to a 16-row tile; t=20 spans two rhs blocks."""
        x = rng.standard_normal((ela_small.shape[0], t))
        y = _triton(ela_small, 3, x, chunk=128)
        np.testing.assert_allclose(y, ela_small @ x, rtol=1e-12, atol=1e-12)

    def test_f32_with_bf16_blocks(self, ela_small, rng):
        """bf16-stored blocks widen to f32 in registers."""
        import scipy.sparse as sp

        from prealps_tpu.core.scaling import sym_rac_scaling

        a, _ = sym_rac_scaling(sp.csr_matrix(ela_small))
        x = rng.standard_normal((a.shape[0], 4)).astype(np.float32)
        y = _triton(a, 3, x, dtype=np.float32, blocks_dtype=jnp.bfloat16)
        assert y.dtype == np.float32
        np.testing.assert_allclose(y, a @ x, rtol=0, atol=3e-2 * np.abs(
            a @ x).max())

    def test_pre_extended_ring_halo(self, ela_small, rng):
        """Two shards fed ring halos from each other (the sharded driver's
        ppermute exchange) reproduce A @ x."""
        a = ela_small
        st = csr_to_stencil_bsr_t(a, br=3, dtype=np.float64)
        halo = max(abs(o) for o in st.offsets)
        nrb = a.shape[0] // 3
        x = rng.standard_normal((a.shape[0], 4))
        xt = panel_to_lane_major(jnp.asarray(x), 3)
        cut = nrb // 2
        assert cut >= halo and nrb - cut >= halo
        parts = [(0, cut), (cut, nrb)]
        ys = []
        for i, (r0, r1) in enumerate(parts):
            o0, o1 = parts[1 - i]
            own = xt[:, :, r0:r1]
            other = xt[:, :, o0:o1]
            x_ext = jnp.concatenate(
                [other[:, :, -halo:], own, other[:, :, :halo]], axis=2)
            ys.append(stencil_spmm_triton_ext(
                st.blocks_t[..., r0:r1], tuple(st.offsets), x_ext, halo,
                chunk=64, interpret=True))
        y = np.asarray(panel_from_lane_major(jnp.concatenate(ys, axis=2)))
        np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)


class TestKernelChoice:
    def test_cpu_runs_xla(self):
        from prealps_tpu.ops.spmm import stencil_impl

        assert stencil_impl() == "xla"

    def test_gpu_runs_triton(self, mock_gpu):
        from prealps_tpu.ops.spmm import stencil_impl

        assert stencil_impl() == "triton"

    def test_product_path_calls_triton_on_gpu(self, mock_gpu, monkeypatch,
                                              ela_small, rng):
        """Every shape goes to the Triton kernel on the GPU — no silent
        step aside to the XLA form."""
        from prealps_tpu.ops import spmm

        calls = []
        real = spmm.stencil_spmm_triton_ext

        def spy(*args, **kw):
            calls.append(args[2].shape)
            return real(*args, interpret=True, **kw)

        monkeypatch.setattr(spmm, "stencil_spmm_triton_ext", spy)
        monkeypatch.setattr(spmm, "stencil_spmm_xla_ext", None)
        st = csr_to_stencil_bsr_t(ela_small, br=3, dtype=np.float64)
        for t in (1, 40):   # thin and wide panels alike
            x = rng.standard_normal((ela_small.shape[0], t))
            y = spmm.stencil_bsr_spmm_t(
                st, panel_to_lane_major(jnp.asarray(x), 3))
            np.testing.assert_allclose(
                np.asarray(panel_from_lane_major(y)), ela_small @ x,
                rtol=1e-12, atol=1e-12)
        assert len(calls) == 2

    def test_sharded_solve_through_triton(self, mock_gpu, monkeypatch,
                                          ela_small):
        """The lane-major driver path (ring ppermute halos, 2 shards) with
        the Triton kernel in interpret mode converges like the XLA path."""
        import functools

        from prealps_tpu.ops import spmm
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers import ECGOptions

        monkeypatch.setattr(
            spmm, "stencil_spmm_triton_ext",
            functools.partial(spmm.stencil_spmm_triton_ext, interpret=True))
        b = np.random.default_rng(3).standard_normal(ela_small.shape[0])
        s = DistributedECG.build(
            ela_small, nshards=2, dtype=np.float64, fmt="stencil", br=3,
            opts=ECGOptions(t=4, tol=1e-8, maxiter=2000, layout="tbn"),
            precond="chebyshev")
        x, info = s.solve(b)
        assert np.linalg.norm(b - ela_small @ x) / np.linalg.norm(b) < 1e-7


class TestBlockEllXla:
    def test_block_ell_two_shards(self, poisson_small, rng):
        """fmt='block_ell' solves through the XLA gather path."""
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers import ECGOptions

        b = rng.standard_normal(poisson_small.shape[0])
        s = DistributedECG.build(
            poisson_small, nshards=2, fmt="block_ell", precond="none",
            opts=ECGOptions(t=2, tol=1e-8, maxiter=500), dtype=np.float64)
        x, _ = s.solve(b)
        assert np.linalg.norm(b - poisson_small @ x) / np.linalg.norm(b) \
            < 1e-7

    def test_operands_placed_per_shard(self, poisson_small):
        """Each operand holds one shard on each mesh device after build."""
        from prealps_tpu.parallel.driver import DistributedECG
        from prealps_tpu.solvers import ECGOptions

        s = DistributedECG.build(
            poisson_small, nshards=4, fmt="block_ell", precond="block_jacobi",
            opts=ECGOptions(t=2, tol=1e-6), dtype=np.float64)
        for arr in jax.tree_util.tree_leaves(s._operands):
            devs = {sh.device for sh in arr.addressable_shards}
            assert devs == set(s.mesh.devices.flat)


class TestPlatformPolicy:
    @pytest.mark.parametrize("gpu,requested,want", [
        (False, None, np.float64),
        (True, None, np.float32),
        (True, "f64", np.float64),
        (False, "f32", np.float32),
    ])
    def test_solve_dtype(self, monkeypatch, gpu, requested, want):
        from prealps_tpu.config import solve_dtype

        if gpu:
            monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert np.dtype(solve_dtype(requested)) == np.dtype(want)

    def test_panel_layout(self, monkeypatch):
        from prealps_tpu.config import panel_layout

        assert panel_layout("stencil") == "nt"            # CPU
        assert panel_layout("stencil", "bj2l") == "tbn"   # bj2l needs tbn
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert panel_layout("stencil") == "tbn"
        assert panel_layout("dia") == "tbn"
        assert panel_layout("block_ell") == "nt"
        assert panel_layout("ell") == "nt"

    @pytest.mark.parametrize("gpu", [False, True])
    def test_factor_store(self, monkeypatch, gpu):
        from prealps_tpu.config import factor_store_dtype

        if gpu:
            monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert factor_store_dtype(None, np.float32) == "f32"
        assert factor_store_dtype("auto", np.float32) == "f32"
        assert factor_store_dtype("bf16", np.float32) == "bf16"
        assert factor_store_dtype("bf16", np.float64) == "f32"
        with pytest.raises(ValueError):
            factor_store_dtype("fp8", np.float32)


class TestCompileCache:
    @pytest.fixture()
    def restore_cache_dir(self):
        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_var_honoured(self, monkeypatch, restore_cache_dir, tmp_path):
        from prealps_tpu.config import init_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert init_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_path_in_checkout(self, monkeypatch, restore_cache_dir):
        from prealps_tpu.config import init_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = init_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestChipSmokeOffChip:
    def _run(self, cwd):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        return subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300)

    def _assert_no_result(self, r):
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_fails_on_cpu(self):
        self._assert_no_result(self._run(REPO))

    def test_fails_without_the_repo(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        self._assert_no_result(self._run(str(tmp_path)))
