"""IVFIndex tests (mirrors ivf_index_test.go + ivf_index_search_test.go +
ivf_index_document_filter_test.go coverage, plus recall-vs-flat-oracle)."""

import io

import numpy as np
import pytest

from comet_tpu.indexes.ivf import IVFIndex
from comet_tpu.types import (
    DistanceKind,
    InvalidConfigError,
    NotTrainedError,
    VectorIndexKind,
)

from oracle import distances_np, recall_at_k, topk_np


def clustered_data(rng, n_per=100, d=8):
    centers = np.array([[0.0] * d, [20.0] * d, [-20.0] * d], dtype=np.float32)
    return np.concatenate(
        [c + rng.normal(scale=0.5, size=(n_per, d)).astype(np.float32) for c in centers]
    )


def trained_index(rng, nlist=3, d=8):
    idx = IVFIndex(d, nlist, DistanceKind.L2)
    data = clustered_data(rng, d=d)
    idx.train(data)
    idx.add_batch(data, ids=list(range(1, len(data) + 1)))
    return idx, data


def test_kind_and_params():
    idx = IVFIndex(4, 16)
    assert idx.kind() == VectorIndexKind.IVF
    assert idx.nlist == 16
    assert idx.default_nprobes() == 4
    assert not idx.trained()


def test_invalid_nlist():
    with pytest.raises(InvalidConfigError):
        IVFIndex(4, 0)


def test_add_before_train_errors():
    idx = IVFIndex(4, 2)
    with pytest.raises(NotTrainedError):
        idx.add_batch(np.zeros((1, 4), dtype=np.float32))


def test_search_before_train_errors():
    idx = IVFIndex(4, 2)
    with pytest.raises(NotTrainedError):
        idx.new_search().with_query([0.0] * 4).execute()


def test_train_requires_nlist_vectors(rng):
    idx = IVFIndex(4, 10)
    with pytest.raises(InvalidConfigError):
        idx.train(rng.normal(size=(5, 4)).astype(np.float32))


def test_basic_search_finds_neighbors(rng):
    idx, data = trained_index(rng)
    res = idx.new_search().with_query(data[0]).with_k(5).execute()
    assert res[0].node.id == 1
    assert res[0].score == pytest.approx(0.0, abs=1e-4)
    assert len(res) == 5


def test_nprobe_full_equals_flat_oracle(rng):
    """nprobe = nlist probes everything -> exact results."""
    idx, data = trained_index(rng)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    ws, wi = topk_np(distances_np(q, data, "l2"), 10)
    for qi in range(3):
        res = (
            idx.new_search().with_query(q[qi]).with_k(10).with_nprobes(3).execute()
        )
        got = [r.node.id for r in res]
        want = [int(j) + 1 for j in wi[qi]]
        assert got == want


def test_nprobe_sanitization(rng):
    idx, data = trained_index(rng)
    # nprobe <= 0 or > nlist -> nlist (exact)
    res0 = idx.new_search().with_query(data[0]).with_k(5).with_nprobes(0).execute()
    res_many = idx.new_search().with_query(data[0]).with_k(5).with_nprobes(99).execute()
    assert [r.node.id for r in res0] == [r.node.id for r in res_many]


def test_higher_nprobe_no_worse_recall(rng):
    d = 16
    idx = IVFIndex(d, 16, DistanceKind.L2)
    data = rng.normal(size=(2000, d)).astype(np.float32)
    idx.train(data[:1000])
    idx.add_batch(data, ids=list(range(1, 2001)))
    q = rng.normal(size=(8, d)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data, "l2"), 10)
    true_ids = wi + 1

    recalls = []
    for nprobe in (1, 4, 16):
        found = []
        for qi in range(8):
            res = idx.new_search().with_query(q[qi]).with_k(10).with_nprobes(nprobe).execute()
            found.append([r.node.id for r in res])
        recalls.append(recall_at_k(found, true_ids))
    assert recalls[0] <= recalls[1] + 1e-9 <= recalls[2] + 2e-9
    assert recalls[2] == 1.0  # full probe = exact


def test_soft_delete_and_flush(rng):
    idx, data = trained_index(rng)
    idx.remove(1)
    res = idx.new_search().with_query(data[0]).with_k(5).with_nprobes(3).execute()
    assert 1 not in [r.node.id for r in res]
    idx.flush()
    res = idx.new_search().with_query(data[0]).with_k(5).with_nprobes(3).execute()
    assert 1 not in [r.node.id for r in res]
    assert idx.count() == len(data) - 1


def test_document_filter(rng):
    idx, data = trained_index(rng)
    res = (
        idx.new_search()
        .with_query(data[0])
        .with_k(10)
        .with_nprobes(3)
        .with_document_ids([5, 6, 7])
        .execute()
    )
    assert sorted(r.node.id for r in res) == [5, 6, 7]


def test_threshold(rng):
    idx, data = trained_index(rng)
    res = (
        idx.new_search().with_query(data[0]).with_k(300).with_nprobes(3)
        .with_threshold(5.0).execute()
    )
    assert all(r.score <= 5.0 for r in res)
    assert len(res) > 0


def test_multi_query_aggregation(rng):
    idx, data = trained_index(rng)
    res = (
        idx.new_search().with_query(data[0]).with_query(data[1])
        .with_k(5).with_nprobes(3).execute()
    )
    assert len(res) == 5


def test_serialization_roundtrip(rng):
    idx, data = trained_index(rng)
    buf = io.BytesIO()
    idx.write_to(buf)
    buf.seek(0)
    idx2 = IVFIndex(8, 3, DistanceKind.L2)
    idx2.read_from(buf)
    assert idx2.trained()
    assert idx2.count() == idx.count()
    r1 = idx.new_search().with_query(data[0]).with_k(5).execute()
    r2 = idx2.new_search().with_query(data[0]).with_k(5).execute()
    assert [r.node.id for r in r1] == [r.node.id for r in r2]


def test_serialization_param_mismatch(rng):
    idx, _ = trained_index(rng)
    buf = io.BytesIO()
    idx.write_to(buf)
    from comet_tpu.io.serial import SerializationError

    buf.seek(0)
    with pytest.raises(SerializationError):
        IVFIndex(8, 5, DistanceKind.L2).read_from(buf)


def test_retrain_reassigns(rng):
    idx, data = trained_index(rng)
    idx.train(data)  # retrain
    res = idx.new_search().with_query(data[0]).with_k(3).with_nprobes(1).execute()
    assert res[0].node.id == 1


def test_high_nprobe_routes_to_sparse_path(rng):
    # a probe count past half the lists walks most chunks per query and
    # must still match the exact oracle
    d, nlist = 16, 128
    data = rng.normal(size=(4096, d)).astype(np.float32)
    idx = IVFIndex(d, nlist, DistanceKind.L2)
    idx.train(data)
    idx.add_batch(data, ids=list(range(len(data))))
    q = data[7] + 0.01
    res = (
        idx.new_search().with_query(q).with_k(10).with_nprobes(64).execute()
    )
    assert len(res) == 10
    ids = [r.get_id() for r in res]
    assert 7 in ids
    # full probe (nprobe == nlist) is exact: equals the flat oracle
    res_full = (
        idx.new_search().with_query(q).with_k(10).with_nprobes(nlist).execute()
    )
    truth = topk_np(distances_np(q[None], data, "l2"), 10)[1][0]
    assert [r.get_id() for r in res_full] == [int(t) for t in truth]
