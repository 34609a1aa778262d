"""Device naming and selection: measurement paths fail without a GPU, the
native helpers build for the CPU's baseline instruction set, and the card
tests (marker `gpu`, run with `python -m pytest -m gpu` on a GPU host)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from comet_tpu.utils.device import NoGPUError, require_gpu

from oracle import distances_np, topk_np


def test_require_gpu_refuses_the_cpu_backend():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(NoGPUError):
        require_gpu()


def test_bench_exits_non_zero_without_gpu(monkeypatch, capsys):
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    import bench

    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    assert '"metric"' not in capsys.readouterr().out


def test_native_build_targets_the_baseline_isa(monkeypatch):
    """The on-demand build never passes -march=native: a copied checkout
    may carry the binary to another CPU."""
    from comet_tpu import native

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)

    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native._build()
    assert calls and not any("march" in a for a in calls[0])


@pytest.mark.gpu
def test_gpu_exact_flat_search_keeps_float32_products():
    """On the card, exact search must match a float64 oracle to float32
    rounding: a TF32 product (10-bit mantissa) would miss by far more."""
    from comet_tpu import DistanceKind, FlatIndex

    rng = np.random.default_rng(0)
    data = rng.integers(0, 128, size=(65536, 128)).astype(np.float32)
    q = rng.integers(0, 128, size=(256, 128)).astype(np.float32)
    idx = FlatIndex(128, DistanceKind.L2_SQUARED)
    idx.add_batch(data, ids=np.arange(1, 65537))
    ids, scores = idx.search_batch(q, k=50)
    want = distances_np(q, data, "l2_squared", dtype=np.float64)
    # integer data: every squared distance is an integer below 2^24, exact
    # in float32 when the products are
    want_s, want_i = topk_np(want, 50)
    np.testing.assert_array_equal(scores, want_s)
    np.testing.assert_array_equal(ids, want_i + 1)


@pytest.mark.gpu
def test_gpu_distance_precision_is_true_float32():
    """DEFAULT_PRECISION products keep float32's 24-bit significand on the
    card: 1 + 2^-12 needs 13 bits, which TF32 (10 bits) rounds away."""
    from comet_tpu.ops.distance import DEFAULT_PRECISION

    a = jnp.full((8, 64), 1.0 + 2.0 ** -12, jnp.float32)
    b = jnp.ones((16, 64), jnp.float32)
    ip = np.asarray(jnp.dot(a, b.T, precision=DEFAULT_PRECISION))
    np.testing.assert_array_equal(ip, np.float32(64.0 + 2.0 ** -6))
