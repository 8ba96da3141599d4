"""Test configuration: 8 virtual CPU devices + float64.

The reference is verified with `mpirun -np N` on one box (SURVEY.md §4); the
analog here is an 8-device virtual CPU mesh via
--xla_force_host_platform_device_count, with x64 enabled so solver tests can
compare against float64 scipy references.
"""

import os

# Force CPU even where a GPU is present (GPU checks run in child processes,
# tests/test_gpu.py). jax may already be imported before this file runs, so
# the env var alone is not enough — use config updates post-import.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) >= 8, "tests need 8 virtual CPU devices"

import numpy as np
import pytest
import scipy.sparse as sp


@pytest.fixture()
def rng():
    """Fresh deterministic generator per test (order-independent data)."""
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def lfat5():
    """The 14x14 SPD LFAT5 matrix (SuiteSparse), the reference's smoke matrix.

    Loaded from the read-only reference checkout when present, else skipped.
    """
    path = "/root/reference/matrix/LFAT5.mtx"
    if not os.path.exists(path):
        pytest.skip("LFAT5.mtx not available")
    from prealps_tpu.core.io import load_mtx

    return load_mtx(path)


@pytest.fixture(scope="session")
def ela_small():
    """Small heterogeneous 3-D elasticity matrix (same family as the
    reference's elasticity3d_12x10x10_var benchmark)."""
    from prealps_tpu.core.generators import elasticity3d

    return elasticity3d(6, 5, 5)


@pytest.fixture(scope="session")
def poisson_small():
    from prealps_tpu.core.generators import poisson3d

    return poisson3d(8, 8, 8)
