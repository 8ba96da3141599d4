"""Checks that need a GPU: the Triton stencil kernel compiled for the card.

Each test runs its check in a child process that sees the real backend (this
suite's conftest pins the parent to the CPU). The `gpu` fixture decides at
run time whether a card is present and skips otherwise. On a machine with a
GPU: python -m pytest tests/ -m gpu
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KERNEL_CHECK = r"""
import numpy as np, jax, jax.numpy as jnp
from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
from prealps_tpu.ops.spmm import (attach_wrap_halo, panel_from_lane_major,
    panel_to_lane_major, stencil_impl, stencil_spmm_ext, stencil_spmm_xla_ext)
assert jax.devices()[0].platform == "gpu" and stencil_impl() == "triton"
a = elasticity3d(12, 10, 10)
for dt, t in ((np.float32, 12), (np.float64, 3)):
    with jax.enable_x64(dt == np.float64):
        st = csr_to_stencil_bsr_t(a, br=3, dtype=dt)
        offs = tuple(st.offsets); h = max(abs(o) for o in offs)
        x = np.random.default_rng(0).standard_normal((a.shape[0], t)).astype(dt)
        xt = panel_to_lane_major(jnp.asarray(x), 3)
        run = lambda f: np.asarray(panel_from_lane_major(jax.jit(
            lambda b, v: f(b, offs, attach_wrap_halo(v, h), h))(st.blocks_t, xt)),
            np.float64)
        y, y_ref = run(stencil_spmm_ext), a @ x.astype(np.float64)
        bound = (1e-5 if dt == np.float32 else 1e-12) * np.abs(abs(a) @ np.abs(x)).max()
        assert np.abs(y - y_ref).max() <= bound, (dt, np.abs(y - y_ref).max())
        assert np.abs(y - run(stencil_spmm_xla_ext)).max() <= bound
print("OK")
"""


@pytest.fixture()
def gpu():
    try:
        ok = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                            timeout=60).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        ok = False
    if not ok:
        pytest.skip("no GPU on this machine")


def _run_on_gpu(script):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)


@pytest.mark.gpu
def test_triton_stencil_compiled_on_card(gpu):
    r = _run_on_gpu(KERNEL_CHECK)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr
