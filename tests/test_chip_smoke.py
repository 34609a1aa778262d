"""chip_smoke.py at a tiny size on the CPU backend.

Each phase runs through the same public API and float64 oracle checks as on
the GPU, at a few thousand rows; main() must refuse to run without a GPU.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke as smoke  # the repo root is on sys.path (conftest.py)

TINY = dict(
    rows=4096, queries=64, check=16, k=10, nlist=16, ivf_nprobe=4, pq_m=8,
    ivfpq_nprobe=4, nrefine=32, train_rows=4096,
    hnsw_ef_construction=64, hnsw_ef=64, hybrid_rows=2048, hybrid_k=10,
    store_rows=512, store_k=10, store_check=16, data="gen_data",
)


@pytest.fixture(scope="module")
def ctx():
    return smoke.make_context(smoke.Config(**TINY), card="cpu test")


@pytest.mark.parametrize("name", list(smoke.PHASES))
def test_phase_matches_oracle_at_tiny_size(ctx, name):
    out = smoke.PHASES[name](ctx)
    assert out


def test_four_card_phase_on_virtual_devices(ctx):
    """The --four-cards path on the 8 virtual CPU devices of the test
    mesh: sharded flat/IVF/hybrid and the k-means step against the oracle."""
    out = smoke.phase_four_cards(ctx)
    assert out["flat"]["checked"] == ctx.check
    assert out["kmeans"]["assign_agree"] >= 0.999


def test_check_exact_rejects_a_wrong_neighbour(ctx):
    """A returned row that is not a near-tie of the oracle's fails."""
    sq = ctx.oracle.sq[:2]
    order = np.argsort(sq, axis=1, kind="stable")[:, :10]
    ids = order + 1
    scores = np.sqrt(np.take_along_axis(sq, order, axis=1))
    smoke.check_exact("ok", ids, scores, sq, 10, ctx.oracle.bound)
    bad = ids.copy()
    bad[0, 3] = np.argsort(sq[0])[500] + 1
    with pytest.raises(smoke.PhaseError):
        smoke.check_exact("bad", bad, scores, sq, 10, ctx.oracle.bound)


def test_check_exact_rejects_a_wrong_score(ctx):
    sq = ctx.oracle.sq[:1]
    order = np.argsort(sq, axis=1, kind="stable")[:, :10]
    scores = np.sqrt(np.take_along_axis(sq, order, axis=1)) * 1.001
    with pytest.raises(smoke.PhaseError):
        smoke.check_exact("bad", order + 1, scores, sq, 10, ctx.oracle.bound)


def test_main_refuses_without_gpu(capsys):
    """No GPU: exit non-zero and print no ok line."""
    rc = smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out


def test_tiny_config_is_a_scaled_default():
    """The tiny sizes above name only fields the full run has."""
    names = {f.name for f in dataclasses.fields(smoke.Config)}
    assert set(TINY) <= names
