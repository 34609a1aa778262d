"""HNSW tests (mirrors hnsw_index_test.go + hnsw_index_search_test.go +
hnsw_index_document_filter_test.go coverage: recall bounds vs flat oracle,
efSearch monotonicity, filter/delete/flush behavior, serialization)."""

import io

import numpy as np
import pytest

from comet_tpu.indexes.hnsw import HNSWConfig, HNSWIndex
from comet_tpu.types import (
    DistanceKind,
    InvalidConfigError,
    NodeNotFoundError,
    VectorIndexKind,
)

from oracle import distances_np, recall_at_k, topk_np


def build_hnsw(rng, n=400, dim=16, m=8, efc=64, kind=DistanceKind.L2):
    idx = HNSWIndex(dim, kind, HNSWConfig(m=m, ef_construction=efc, ef_search=efc))
    data = rng.normal(size=(n, dim)).astype(np.float32)
    idx.add_batch(data, ids=list(range(1, n + 1)))
    return idx, data


def test_kind_and_config():
    idx = HNSWIndex(8)
    assert idx.kind() == VectorIndexKind.HNSW
    assert idx.config.m == 16
    assert idx.config.ef_construction == 200
    idx.set_ef_search(99)
    assert idx.config.ef_search == 99
    with pytest.raises(InvalidConfigError):
        HNSWIndex(8, config=HNSWConfig(m=0))


def test_single_node_and_self_query(rng):
    idx = HNSWIndex(4)
    idx.add_batch(np.array([[1.0, 0, 0, 0]], dtype=np.float32), ids=[7])
    res = idx.new_search().with_query([1.0, 0, 0, 0]).with_k(5).execute()
    assert [r.node.id for r in res] == [7]
    assert res[0].score == pytest.approx(0.0, abs=1e-5)


def test_self_queries_find_themselves(rng):
    idx, data = build_hnsw(rng, n=300)
    hits = 0
    for i in range(0, 300, 17):
        res = idx.new_search().with_query(data[i]).with_k(1).execute()
        hits += res[0].node.id == i + 1
    assert hits >= 16  # nearly all self-queries resolve exactly


def test_recall_vs_flat_oracle(rng):
    idx, data = build_hnsw(rng, n=500, dim=16, m=8, efc=100)
    q = rng.normal(size=(16, 16)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data, "l2"), 10)
    found = []
    for qi in range(16):
        res = idx.new_search().with_query(q[qi]).with_k(10).with_ef_search(128).execute()
        found.append([r.node.id for r in res])
    rec = recall_at_k(found, wi + 1)
    assert rec >= 0.9, rec


def test_higher_ef_search_no_worse_recall(rng):
    idx, data = build_hnsw(rng, n=600, dim=16, m=6, efc=48)
    q = rng.normal(size=(12, 16)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data, "l2"), 10)
    recalls = []
    for ef in (10, 64, 256):
        found = []
        for qi in range(12):
            res = idx.new_search().with_query(q[qi]).with_k(10).with_ef_search(ef).execute()
            found.append([r.node.id for r in res])
        recalls.append(recall_at_k(found, wi + 1))
    assert recalls[0] <= recalls[2] + 1e-9
    assert recalls[2] >= 0.85


def test_document_filter_fused_returns_k(rng):
    """Selective filters must still return k results (the reference's
    post-filter can return fewer; ours fuses the mask into the beam)."""
    idx, data = build_hnsw(rng, n=400)
    allowed = list(range(1, 21))  # 5% of docs
    res = (
        idx.new_search().with_query(data[0]).with_k(10)
        .with_document_ids(allowed).with_ef_search(256).execute()
    )
    # best-effort: the beam admits allowed nodes as it traverses; with a 5%
    # filter it should find (nearly) all k — the reference's post-filter
    # typically returns far fewer under selective filters.
    assert len(res) >= 8
    assert all(r.node.id in allowed for r in res)


def test_threshold(rng):
    idx, data = build_hnsw(rng)
    res = (
        idx.new_search().with_query(data[0]).with_k(50).with_threshold(3.0)
        .execute()
    )
    assert all(r.score <= 3.0 for r in res)


def test_soft_delete_and_flush(rng):
    idx, data = build_hnsw(rng, n=200)
    res = idx.new_search().with_query(data[0]).with_k(1).execute()
    assert res[0].node.id == 1
    idx.remove(1)
    assert idx.count() == 199
    res = idx.new_search().with_query(data[0]).with_k(5).execute()
    assert 1 not in [r.node.id for r in res]

    idx.flush()
    assert idx.count() == 199
    res = idx.new_search().with_query(data[1]).with_k(5).execute()
    assert res[0].node.id == 2
    # recall still reasonable after compaction remap
    q = rng.normal(size=(8, 16)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data[1:], "l2"), 5)
    found = []
    for qi in range(8):
        res = idx.new_search().with_query(q[qi]).with_k(5).with_ef_search(128).execute()
        found.append([r.node.id for r in res])
    assert recall_at_k(found, wi + 2) >= 0.8


def test_flush_all_deleted(rng):
    idx = HNSWIndex(4)
    idx.add_batch(np.eye(4, dtype=np.float32), ids=[1, 2, 3, 4])
    for i in (1, 2, 3, 4):
        idx.remove(i)
    idx.flush()
    assert idx.count() == 0
    res = idx.new_search().with_query([1.0, 0, 0, 0]).with_k(3).execute()
    assert res == []


def test_with_node_and_missing(rng):
    idx, data = build_hnsw(rng, n=100)
    res = idx.new_search().with_node(5).with_k(3).execute()
    assert res[0].node.id == 5
    with pytest.raises(NodeNotFoundError):
        idx.new_search().with_node(9999).execute()


def test_multi_query_aggregation(rng):
    idx, data = build_hnsw(rng, n=100)
    res = (
        idx.new_search().with_query(data[0]).with_query(data[1]).with_k(5).execute()
    )
    assert len(res) == 5


def test_cosine_hnsw(rng):
    idx, data = build_hnsw(rng, n=300, kind=DistanceKind.COSINE)
    res = idx.new_search().with_query(data[10]).with_k(3).execute()
    assert res[0].node.id == 11
    assert res[0].score == pytest.approx(0.0, abs=1e-5)


def test_incremental_adds(rng):
    """Multiple add_batch calls keep the graph connected."""
    idx = HNSWIndex(8, DistanceKind.L2, HNSWConfig(m=8, ef_construction=48, ef_search=48))
    data = rng.normal(size=(300, 8)).astype(np.float32)
    for lo in range(0, 300, 50):
        idx.add_batch(data[lo : lo + 50], ids=list(range(lo + 1, lo + 51)))
    q = rng.normal(size=(8, 8)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data, "l2"), 5)
    found = []
    for qi in range(8):
        res = idx.new_search().with_query(q[qi]).with_k(5).with_ef_search(128).execute()
        found.append([r.node.id for r in res])
    assert recall_at_k(found, wi + 1) >= 0.85


def test_serialization_roundtrip(rng):
    idx, data = build_hnsw(rng, n=150)
    buf = io.BytesIO()
    idx.write_to(buf)
    buf.seek(0)
    idx2 = HNSWIndex(16, DistanceKind.L2, HNSWConfig(m=8, ef_construction=64, ef_search=64))
    idx2.read_from(buf)
    assert idx2.count() == 150
    r1 = idx.new_search().with_query(data[3]).with_k(5).execute()
    r2 = idx2.new_search().with_query(data[3]).with_k(5).execute()
    assert [r.node.id for r in r1] == [r.node.id for r in r2]
    np.testing.assert_allclose(
        [r.score for r in r1], [r.score for r in r2], rtol=1e-5
    )


def test_serialization_param_mismatch(rng):
    idx, _ = build_hnsw(rng, n=50)
    buf = io.BytesIO()
    idx.write_to(buf)
    from comet_tpu.io.serial import SerializationError

    buf.seek(0)
    with pytest.raises(SerializationError):
        HNSWIndex(16, DistanceKind.L2, HNSWConfig(m=4)).read_from(buf)


def test_duplicate_id_rejected(rng):
    idx, _ = build_hnsw(rng, n=20)
    with pytest.raises(InvalidConfigError):
        idx.add_batch(np.zeros((1, 16), dtype=np.float32), ids=[5])


def test_seed_state_incremental_maintenance(rng, monkeypatch):
    """Seed lists must survive small mutations without a full O(n*nlist)
    reassignment + list rebuild (ADVICE r3): adds extend the cached
    per-slot assignment; removals rebuild nothing (the seed scan masks by
    current validity); the lists rebuild only past the debounce threshold
    or after a flush."""
    import jax.numpy as jnp

    import comet_tpu.indexes.hnsw as hnsw_mod

    monkeypatch.setattr(hnsw_mod, "SEED_REBUILD_MIN", 64)
    idx, data = build_hnsw(rng, n=600, dim=8)
    st1 = idx._ensure_seed()
    t1 = st1["chunk_slots"]
    assert idx._seed_layout_n == 600
    assert idx._seed_assign_n == 600

    # small add: assignments extend, lists NOT rebuilt
    extra = rng.normal(size=(5, 8)).astype(np.float32)
    idx.add_batch(extra, ids=list(range(1001, 1006)))
    st2 = idx._ensure_seed()
    assert st2["chunk_slots"] is t1
    assert idx._seed_layout_n == 600
    assert idx._seed_assign_n == 605
    assert idx._seed_version == idx._store.version

    # removal: the slot stays listed, but the seed scan never returns it
    slot = idx._store.id_to_slot[3]
    idx.remove(3)
    st3 = idx._ensure_seed()
    assert st3["chunk_slots"] is t1
    assert (np.asarray(st3["chunk_slots"]) == slot).sum() == 1
    _, seeds = idx._seed_scan(jnp.asarray(idx._store.vectors[slot][None]), 16)
    assert slot not in np.asarray(seeds)

    # big add past the debounce: full rebuild picks the new slots up
    big = rng.normal(size=(80, 8)).astype(np.float32)
    idx.add_batch(big, ids=list(range(2001, 2081)))
    st4 = idx._ensure_seed()
    assert st4["chunk_slots"] is not t1
    assert idx._seed_layout_n == idx._store.n
    # removed slot is gone from the rebuilt lists entirely
    assert not np.any(np.asarray(st4["chunk_slots"]) == slot)

    # flush permutes slots: caches must die and rebuild cleanly
    idx.remove(5)
    idx.flush()
    st5 = idx._ensure_seed()
    assert idx._seed_layout_n == idx._store.n
    lists = np.asarray(st5["chunk_slots"])
    live = lists[lists >= 0]
    assert len(live) == idx._store.n == idx.count()
    # every listed row maps to a valid slot
    assert idx._store.valid[live].all()
