"""FlatIndex end-to-end tests (mirrors flat_index_test.go +
flat_index_search_test.go + flat_index_document_filter_test.go coverage,
plus the flat-as-oracle exactness harness the reference lacks)."""

import io

import numpy as np
import pytest

from comet_tpu.core.node import VectorNode, new_vector_node
from comet_tpu.indexes.flat import FlatIndex
from comet_tpu.types import (
    DimensionMismatchError,
    DistanceKind,
    InvalidConfigError,
    NodeNotFoundError,
    VectorIndexKind,
    ZeroVectorError,
)

from oracle import distances_np, topk_np


def small_index():
    idx = FlatIndex(2, DistanceKind.L2)
    # known layout: id 1 at origin-ish, ids spread on a line
    vecs = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [10.0, 0.0]], dtype=np.float32)
    idx.add_batch(vecs, ids=[1, 2, 3, 4])
    return idx


def test_kind_and_dimensions():
    idx = small_index()
    assert idx.kind() == VectorIndexKind.FLAT
    assert idx.dimensions() == 2
    assert idx.distance_kind() == DistanceKind.L2
    assert idx.trained() is True
    assert idx.count() == 4


def test_basic_knn_order():
    idx = small_index()
    res = idx.new_search().with_query([0.1, 0.0]).with_k(3).execute()
    assert [r.node.id for r in res] == [1, 2, 3]
    assert res[0].score == pytest.approx(0.1, abs=1e-5)


def test_k_defaults_to_10_and_clamps():
    idx = small_index()
    res = idx.new_search().with_query([0.0, 0.0]).execute()
    assert len(res) == 4  # only 4 vectors
    res = idx.new_search().with_query([0.0, 0.0]).with_k(0).execute()
    assert len(res) == 4  # k<=0 means all


def test_requires_query_or_node():
    idx = small_index()
    with pytest.raises(InvalidConfigError):
        idx.new_search().with_k(3).execute()


def test_dimension_mismatch():
    idx = small_index()
    with pytest.raises(DimensionMismatchError):
        idx.new_search().with_query([1.0, 2.0, 3.0]).execute()
    with pytest.raises(DimensionMismatchError):
        idx.add(VectorNode(99, np.zeros(3, dtype=np.float32)))


def test_with_node_query():
    idx = small_index()
    res = idx.new_search().with_node(2).with_k(2).execute()
    assert [r.node.id for r in res] == [2, 1]  # node 2 itself, then neighbor


def test_with_node_missing_errors():
    idx = small_index()
    with pytest.raises(NodeNotFoundError):
        idx.new_search().with_node(999).execute()


def test_with_node_deleted_errors():
    idx = small_index()
    idx.remove(2)
    with pytest.raises(NodeNotFoundError):
        idx.new_search().with_node(2).execute()


def test_threshold_filters():
    idx = small_index()
    res = idx.new_search().with_query([0.0, 0.0]).with_k(10).with_threshold(1.5).execute()
    assert [r.node.id for r in res] == [1, 2]
    # threshold 0 = disabled
    res = idx.new_search().with_query([0.0, 0.0]).with_k(10).with_threshold(0.0).execute()
    assert len(res) == 4


def test_document_filter():
    idx = small_index()
    res = (
        idx.new_search()
        .with_query([0.0, 0.0])
        .with_k(10)
        .with_document_ids([3, 4])
        .execute()
    )
    assert [r.node.id for r in res] == [3, 4]


def test_soft_delete_and_flush():
    idx = small_index()
    idx.remove(1)
    assert idx.count() == 3
    res = idx.new_search().with_query([0.0, 0.0]).with_k(10).execute()
    assert 1 not in [r.node.id for r in res]
    idx.flush()
    assert idx.count() == 3
    res = idx.new_search().with_query([0.0, 0.0]).with_k(10).execute()
    assert [r.node.id for r in res] == [2, 3, 4]


def test_remove_missing_errors():
    idx = small_index()
    with pytest.raises(NodeNotFoundError):
        idx.remove(12345)


def test_duplicate_id_rejected():
    idx = small_index()
    with pytest.raises(InvalidConfigError):
        idx.add(VectorNode(1, np.array([5.0, 5.0], dtype=np.float32)))


def test_multi_query_sum_aggregation():
    idx = small_index()
    res = (
        idx.new_search()
        .with_query([0.0, 0.0])
        .with_query([2.0, 0.0])
        .with_k(10)
        .execute()
    )
    # Each id appears in both query results; sum of distances:
    # id1: 0+2=2, id2: 1+1=2, id3: 2+0=2, id4: 10+8=18
    by_id = {r.node.id: r.score for r in res}
    assert by_id[1] == pytest.approx(2.0, abs=1e-5)
    assert by_id[4] == pytest.approx(18.0, abs=1e-5)
    # ties at 2.0 break by ascending id
    assert [r.node.id for r in res] == [1, 2, 3, 4]


def test_multi_query_max_and_mean():
    idx = small_index()
    from comet_tpu.types import ScoreAggregationKind

    res = (
        idx.new_search()
        .with_query([0.0, 0.0])
        .with_query([2.0, 0.0])
        .with_score_aggregation(ScoreAggregationKind.MAX)
        .with_k(10)
        .execute()
    )
    by_id = {r.node.id: r.score for r in res}
    assert by_id[1] == pytest.approx(2.0, abs=1e-5)

    res = (
        idx.new_search()
        .with_query([0.0, 0.0])
        .with_query([2.0, 0.0])
        .with_score_aggregation(ScoreAggregationKind.MEAN)
        .with_k(10)
        .execute()
    )
    by_id = {r.node.id: r.score for r in res}
    assert by_id[4] == pytest.approx(9.0, abs=1e-5)


def test_cosine_index_normalizes_and_rejects_zero():
    idx = FlatIndex(2, DistanceKind.COSINE)
    idx.add_batch(np.array([[3.0, 0.0], [0.0, 5.0]], dtype=np.float32), ids=[1, 2])
    with pytest.raises(ZeroVectorError):
        idx.add(VectorNode(3, np.zeros(2, dtype=np.float32)))
    res = idx.new_search().with_query([1.0, 0.0]).with_k(2).execute()
    assert [r.node.id for r in res] == [1, 2]
    assert res[0].score == pytest.approx(0.0, abs=1e-6)
    assert res[1].score == pytest.approx(1.0, abs=1e-6)


def test_autocut_applied():
    idx = FlatIndex(1, DistanceKind.L2)
    vals = np.array([[0.0], [0.01], [0.02], [5.0], [5.01]], dtype=np.float32)
    idx.add_batch(vals, ids=[1, 2, 3, 4, 5])
    res = idx.new_search().with_query([0.0]).with_k(5).with_cutoff(1).execute()
    assert [r.node.id for r in res] == [1, 2, 3]


def test_reranker_hook():
    idx = small_index()

    class Reverse:
        def rerank(self, results):
            return list(reversed(results))

    res = idx.new_search().with_query([0.0, 0.0]).with_k(3).with_reranker(Reverse()).execute()
    assert [r.node.id for r in res] == [3, 2, 1]


def test_auto_id_assignment():
    idx = FlatIndex(2)
    n1 = new_vector_node(np.array([1.0, 0.0], dtype=np.float32))
    n2 = new_vector_node(np.array([0.0, 1.0], dtype=np.float32))
    idx.add(n1)
    idx.add(n2)
    assert n2.id == n1.id + 1
    res = idx.new_search().with_query([1.0, 0.0]).with_k(1).execute()
    assert res[0].node.id == n1.id


@pytest.mark.parametrize("kind", ["l2", "l2_squared", "cosine"])
def test_exactness_vs_oracle(kind, rng):
    """Flat search must EXACTLY match the brute-force numpy oracle."""
    dk = DistanceKind(kind)
    idx = FlatIndex(16, dk)
    x = rng.normal(size=(500, 16)).astype(np.float32)
    ids = np.arange(100, 600, dtype=np.uint32)
    idx.add_batch(x, ids=ids.tolist())
    q = rng.normal(size=(4, 16)).astype(np.float32)

    from oracle import preprocess_np

    qp = preprocess_np(q, kind)
    xp = preprocess_np(x, kind)
    ws, wi = topk_np(distances_np(qp, xp, kind), 10)

    for qi in range(4):
        res = idx.new_search().with_query(q[qi]).with_k(10).execute()
        got_ids = [r.node.id for r in res]
        want_ids = [int(ids[j]) for j in wi[qi]]
        assert got_ids == want_ids
        got_scores = np.array([r.score for r in res])
        np.testing.assert_allclose(got_scores, ws[qi], rtol=1e-4, atol=1e-4)


def test_serialization_roundtrip():
    idx = small_index()
    idx.remove(4)  # write_to flushes soft deletes first
    buf = io.BytesIO()
    idx.write_to(buf)
    buf.seek(0)

    idx2 = FlatIndex(2, DistanceKind.L2)
    idx2.read_from(buf)
    assert idx2.count() == 3
    res = idx2.new_search().with_query([0.0, 0.0]).with_k(10).execute()
    assert [r.node.id for r in res] == [1, 2, 3]


def test_serialization_param_mismatch():
    idx = small_index()
    buf = io.BytesIO()
    idx.write_to(buf)

    from comet_tpu.io.serial import SerializationError

    buf.seek(0)
    wrong_dim = FlatIndex(3, DistanceKind.L2)
    with pytest.raises(SerializationError):
        wrong_dim.read_from(buf)

    buf.seek(0)
    wrong_kind = FlatIndex(2, DistanceKind.COSINE)
    with pytest.raises(SerializationError):
        wrong_kind.read_from(buf)


def test_serialization_corrupt_magic():
    from comet_tpu.io.serial import SerializationError

    idx = FlatIndex(2)
    with pytest.raises(SerializationError):
        idx.read_from(io.BytesIO(b"JUNKxxxxxxxx"))


def test_capacity_growth(rng):
    idx = FlatIndex(4)
    x = rng.normal(size=(3000, 4)).astype(np.float32)  # > MIN_CAPACITY
    idx.add_batch(x)
    assert idx.count() == 3000
    res = idx.new_search().with_query(x[1777]).with_k(1).execute()
    assert res[0].score == pytest.approx(0.0, abs=1e-4)


def test_bfloat16_storage_mode(rng):
    """Reduced-precision storage: high recall vs the f32 oracle."""
    x = rng.normal(size=(800, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    f32 = FlatIndex(32, DistanceKind.L2)
    f32.add_batch(x, ids=list(range(1, 801)))
    bf16 = FlatIndex(32, DistanceKind.L2, storage="bfloat16")
    bf16.add_batch(x, ids=list(range(1, 801)))

    from oracle import recall_at_k

    exact, approx = [], []
    for qi in range(4):
        exact.append([r.node.id for r in f32.new_search().with_query(q[qi]).with_k(10).execute()])
        approx.append([r.node.id for r in bf16.new_search().with_query(q[qi]).with_k(10).execute()])
    assert recall_at_k(approx, np.array(exact)) >= 0.85


def test_invalid_storage_mode():
    with pytest.raises(InvalidConfigError):
        FlatIndex(8, DistanceKind.L2, storage="int4")


def test_int8_storage_mode(rng):
    """int8 abs-max storage (quantizer.go:180-247 wired as index storage,
    VERDICT r3 #7): high recall vs the f32 oracle; with rerank=True the
    returned scores are the EXACT f32 distances."""
    x = rng.normal(size=(800, 32)).astype(np.float32)
    q = rng.normal(size=(6, 32)).astype(np.float32)
    f32 = FlatIndex(32, DistanceKind.L2)
    f32.add_batch(x, ids=list(range(1, 801)))
    i8 = FlatIndex(32, DistanceKind.L2, storage="int8")
    i8.add_batch(x, ids=list(range(1, 801)))
    rr = FlatIndex(32, DistanceKind.L2, storage="int8", rerank=True)
    rr.add_batch(x, ids=list(range(1, 801)))

    from oracle import recall_at_k

    exact, approx, refined = [], [], []
    for qi in range(6):
        e = f32.new_search().with_query(q[qi]).with_k(10).execute()
        a = i8.new_search().with_query(q[qi]).with_k(10).execute()
        r = rr.new_search().with_query(q[qi]).with_k(10).execute()
        exact.append([res.node.id for res in e])
        approx.append([res.node.id for res in a])
        refined.append([res.node.id for res in r])
        # reranked scores are true f32 distances for every shared id
        escore = {res.node.id: res.score for res in e}
        for res in r:
            if res.node.id in escore:
                assert res.score == pytest.approx(escore[res.node.id], rel=1e-5)
    assert recall_at_k(approx, np.array(exact)) >= 0.8
    assert recall_at_k(refined, np.array(exact)) >= recall_at_k(
        approx, np.array(exact)
    )


def test_int8_trained_scale_and_batch(rng):
    """train(sample) fixes the abs-max scale; batch/fluent agree; threshold
    re-applies exactly under rerank."""
    x = rng.normal(size=(500, 16)).astype(np.float32)
    idx = FlatIndex(16, DistanceKind.L2, storage="int8", rerank=True)
    idx.train(x[:100])
    assert idx._int8_scale is not None
    idx.add_batch(x, ids=list(range(1, 501)))
    q = x[:3] + 0.01
    ids, scores = idx.search_batch(q, k=5)
    for qi in range(3):
        fl = idx.new_search().with_query(q[qi]).with_k(5).execute()
        got = [int(i) for i in ids[qi] if i != np.uint32(0xFFFFFFFF)]
        assert got == [r.node.id for r in fl]
    # threshold in metric space is exact after rerank
    ids_t, scores_t = idx.search_batch(q, k=5, threshold=0.05)
    fin = np.isfinite(scores_t)
    assert (scores_t[fin] <= 0.05 + 1e-6).all()


def test_int8_cosine(rng):
    x = rng.normal(size=(400, 16)).astype(np.float32)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    f32 = FlatIndex(16, DistanceKind.COSINE)
    f32.add_batch(x, ids=list(range(1, 401)))
    i8 = FlatIndex(16, DistanceKind.COSINE, storage="int8", rerank=True)
    i8.add_batch(x, ids=list(range(1, 401)))
    from oracle import recall_at_k

    exact = [[r.node.id for r in f32.new_search().with_query(qq).with_k(10).execute()] for qq in q]
    got = [[r.node.id for r in i8.new_search().with_query(qq).with_k(10).execute()] for qq in q]
    assert recall_at_k(got, np.array(exact)) >= 0.9


def test_rerank_requires_lossy_storage():
    with pytest.raises(InvalidConfigError):
        FlatIndex(8, DistanceKind.L2, storage="float32", rerank=True)


def test_wire_scores_false_matches_ids(rng):
    """wire_scores=False skips the score download (half the result
    transfer at k=100) but must return identical ids; combining with
    score-needing post-steps raises."""
    import pytest

    from comet_tpu.types import InvalidConfigError

    data = rng.normal(size=(500, 16)).astype(np.float32)
    idx = FlatIndex(16, DistanceKind.L2)
    idx.add_batch(data, ids=list(range(1, 501)))
    q = data[:32]
    ids_full, sc = idx.search_batch(q, k=7)
    ids_wire, sc0 = idx.search_batch(q, k=7, wire_scores=False)
    np.testing.assert_array_equal(ids_wire, ids_full)
    # scores are NOT part of the contract with wire_scores=False: only the
    # shape is guaranteed
    assert sc0.shape == sc.shape
    outs = list(idx.search_stream([q, q], k=7, wire_scores=False))
    np.testing.assert_array_equal(outs[1][0], ids_full)
    with pytest.raises(InvalidConfigError):
        idx.search_batch(q, k=7, wire_scores=False, cutoff=3)


def test_narrow_wire_exactness_and_fallback(rng):
    """The narrow wire must be BIT-exact for integral corpora across all
    three widths and must fall back to f32 for anything else."""
    import jax

    from comet_tpu.indexes.base import narrow_wire, upload_f32_exact

    cases = [
        (rng.integers(0, 256, size=(300, 8)).astype(np.float32), np.uint8),
        (rng.integers(-128, 128, size=(300, 8)).astype(np.float32), np.int8),
        (rng.integers(-30000, 30000, size=(300, 8)).astype(np.float32),
         np.int16),
    ]
    for arr, want_dtype in cases:
        wire = narrow_wire(arr)
        assert wire.dtype == want_dtype, (wire.dtype, want_dtype)
        np.testing.assert_array_equal(
            np.asarray(upload_f32_exact(arr)), arr
        )
    # non-integral, out-of-range, and empty fall back untouched
    f = rng.normal(size=(300, 8)).astype(np.float32)
    assert narrow_wire(f).dtype == np.float32
    big = (rng.integers(0, 10, size=(64, 4)) * 100_000).astype(np.float32)
    assert narrow_wire(big).dtype == np.float32
    empty = np.zeros((0, 4), np.float32)
    assert narrow_wire(empty).dtype == np.float32
    # integral SAMPLE but non-integral tail must not be narrowed
    sneaky = np.ones((5000, 4), np.float32)
    sneaky[-1, 0] = 0.5
    assert narrow_wire(sneaky).dtype == np.float32
