"""Test configuration: a virtual 8-device CPU mesh, and the `gpu` marker.

The tests run on the CPU backend (``JAX_PLATFORMS=cpu``); sharding tests
use xla_force_host_platform_device_count=8, which exercises the same
jax.sharding partitioning logic XLA uses across real devices. Tests marked
``gpu`` need an NVIDIA GPU and skip elsewhere; run them on a GPU host with
``python -m pytest -m gpu``.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# Persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX reads it
# itself), else one fixed directory in the checkout.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update(
        "jax_compilation_cache_dir", os.path.join(_repo_root, ".jax_cache")
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
jax.config.update(
    "jax_num_cpu_devices",
    int(os.environ.get("COMET_TEST_CPU_DEVICES", "8")),
)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from comet_tpu.core import node as node_mod  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_ids():
    """Each test starts with a fresh global node-ID counter."""
    node_mod._reset_node_id_counter()
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` run only where JAX's default device is a GPU.
    Decided here, per test, never at import or collection time."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu)")
    yield
