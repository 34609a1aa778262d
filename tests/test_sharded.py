"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from comet_tpu.parallel.sharded import (
    ShardedFlatSearcher,
    ShardedHybridSearcher,
    ShardedIVFSearcher,
    make_corpus_mesh,
    make_sharded_kmeans_step,
    shard_rows,
)
from comet_tpu.types import DistanceKind

from oracle import distances_np, topk_np


def test_mesh_has_8_devices():
    mesh = make_corpus_mesh()
    assert mesh.devices.size == 8


def test_sharded_search_matches_oracle(rng):
    mesh = make_corpus_mesh()
    n, d, k = 4096, 16, 10
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(5, d)).astype(np.float32)

    searcher = ShardedFlatSearcher(mesh, corpus, DistanceKind.L2, tile=256)
    scores, slots = searcher.search(queries, k)

    ws, wi = topk_np(distances_np(queries, corpus, "l2"), k)
    np.testing.assert_array_equal(slots, wi)
    np.testing.assert_allclose(scores, ws, rtol=1e-4, atol=1e-4)


def test_sharded_search_uneven_rows(rng):
    mesh = make_corpus_mesh()
    n, d, k = 1000, 8, 5  # not divisible by 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(3, d)).astype(np.float32)
    searcher = ShardedFlatSearcher(mesh, corpus, DistanceKind.L2, tile=64)
    scores, slots = searcher.search(queries, k)
    ws, wi = topk_np(distances_np(queries, corpus, "l2"), k)
    np.testing.assert_array_equal(slots, wi)


def test_sharded_ivf_matches_single_device(rng):
    """Sharded IVF (row-sharded lists, replicated centroids, all_gather
    merge) returns exactly the single-device IVFIndex's results."""
    from comet_tpu.indexes.ivf import IVFIndex

    mesh = make_corpus_mesh()
    n, d, k, nlist = 4096, 16, 10, 32
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(7, d)).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.uint32)

    idx = IVFIndex(d, nlist, DistanceKind.L2)
    idx.train(corpus[:2048])
    idx.add_batch(corpus, ids=ids)

    sharded = ShardedIVFSearcher(mesh, idx, tile=128)
    for nprobe in (1, 4, 32):
        want_ids, want_sc = idx.search_batch(queries, k=k, nprobes=nprobe)
        s, slots = sharded.search(queries, k, nprobe=nprobe)
        got_ids = sharded.row_ids[np.clip(slots, 0, n - 1)]
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(s, want_sc, rtol=1e-4, atol=1e-4)


def test_sharded_ivf_respects_allowed_mask(rng):
    from comet_tpu.indexes.ivf import IVFIndex

    mesh = make_corpus_mesh()
    n, d, nlist = 1024, 8, 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(3, d)).astype(np.float32)
    idx = IVFIndex(d, nlist, DistanceKind.L2)
    idx.train(corpus)
    idx.add_batch(corpus, ids=np.arange(1, n + 1, dtype=np.uint32))
    sharded = ShardedIVFSearcher(mesh, idx, tile=64)
    allowed = np.zeros(n, dtype=bool)
    allowed[: n // 2] = True
    _, slots = sharded.search(queries, 20, nprobe=nlist, allowed=allowed)
    hit = slots != np.iinfo(np.int32).max
    assert hit.any()
    assert (slots[hit] < n // 2).all()


def test_sharded_pq_matches_single_device(rng):
    """Sharded PQ (reconstructions row-sharded, flat sqrt-L2 scan) returns
    the single-device PQIndex's results."""
    from comet_tpu.indexes.pq import PQIndex
    from comet_tpu.parallel.sharded import ShardedPQSearcher

    mesh = make_corpus_mesh()
    n, d, k, m = 2048, 16, 10, 4
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(6, d)).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.uint32)

    idx = PQIndex(d, DistanceKind.L2, m=m, nbits=6)
    idx.train(corpus[:1024])
    idx.add_batch(corpus, ids=ids)

    sharded = ShardedPQSearcher(mesh, idx, tile=128)
    want_ids, want_sc = idx.search_batch(queries, k=k)
    s, slots = sharded.search(queries, k)
    got_ids = sharded.row_ids[np.clip(slots, 0, n - 1)]
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(s, want_sc, rtol=1e-4, atol=1e-4)


def test_sharded_ivfpq_matches_single_device(rng):
    """Sharded IVFPQ (reconstructions + assignments sharded, coarse probe
    replicated) returns the single-device IVFPQIndex's results."""
    from comet_tpu.indexes.ivfpq import IVFPQIndex
    from comet_tpu.parallel.sharded import ShardedIVFPQSearcher

    mesh = make_corpus_mesh()
    n, d, k, nlist, m = 2048, 16, 10, 16, 4
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(5, d)).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.uint32)

    idx = IVFPQIndex(d, DistanceKind.L2, nlist=nlist, m=m, nbits=6)
    idx.train(corpus[:1024])
    idx.add_batch(corpus, ids=ids)

    sharded = ShardedIVFPQSearcher(mesh, idx, tile=128)
    for nprobe in (2, 16):
        want_ids, want_sc = idx.search_batch(queries, k=k, nprobes=nprobe)
        s, slots = sharded.search(queries, k, nprobe=nprobe)
        got_ids = sharded.row_ids[np.clip(slots, 0, n - 1)]
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(s, want_sc, rtol=1e-4, atol=1e-4)


def test_sharded_ivfpq_allowed_mask_and_deletes(rng):
    from comet_tpu.indexes.ivfpq import IVFPQIndex
    from comet_tpu.parallel.sharded import ShardedIVFPQSearcher

    mesh = make_corpus_mesh()
    n, d, nlist, m = 1024, 8, 8, 4
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(3, d)).astype(np.float32)
    idx = IVFPQIndex(d, DistanceKind.L2, nlist=nlist, m=m, nbits=6)
    idx.train(corpus)
    idx.add_batch(corpus, ids=np.arange(1, n + 1, dtype=np.uint32))
    for doc in range(1, 11):
        idx.remove(doc)  # soft-deleted rows must not surface
    sharded = ShardedIVFPQSearcher(mesh, idx, tile=64)
    allowed = np.zeros(n, dtype=bool)
    allowed[: n // 2] = True
    _, slots = sharded.search(queries, 20, nprobe=nlist, allowed=allowed)
    hit = slots != np.iinfo(np.int32).max
    assert hit.any()
    assert (slots[hit] >= 10).all() and (slots[hit] < n // 2).all()


def test_sharded_hybrid_with_ivfpq_vector(rng):
    """ShardedHybridSearcher drives an IVFPQ vector modality end-to-end."""
    from comet_tpu.indexes.ivfpq import IVFPQIndex
    from comet_tpu.parallel.sharded import ShardedIVFPQSearcher

    mesh = make_corpus_mesh()
    n, d = 512, 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    idx = IVFPQIndex(d, DistanceKind.L2, nlist=8, m=4, nbits=6)
    idx.train(corpus)
    idx.add_batch(corpus, ids=np.arange(1, n + 1, dtype=np.uint32))
    sharded_vec = ShardedIVFPQSearcher(mesh, idx, tile=64)
    hy = ShardedHybridSearcher(sharded_vec, sharded_vec.row_ids)
    out = hy.search_batch(vectors=corpus[:3] + 0.01, k=5, nprobes=8)
    assert len(out) == 3
    assert all(len(row) == 5 for row in out)


def _build_hybrid_corpus(rng, n, d):
    from comet_tpu.core.node import new_metadata_node_with_id
    from comet_tpu.indexes.bm25 import BM25SearchIndex
    from comet_tpu.indexes.flat import FlatIndex
    from comet_tpu.indexes.metadata import RoaringMetadataIndex
    from comet_tpu.hybrid import _DocInfo, new_hybrid_search_index

    corpus = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.uint32)
    words = [f"w{i}" for i in range(64)]
    texts = [
        " ".join(words[int(t)] for t in rng.integers(0, 64, size=6))
        for _ in range(n)
    ]
    cats = ["a", "b", "c"]
    metas = [
        new_metadata_node_with_id(int(ids[i]), {"cat": cats[i % 3], "num": i % 50})
        for i in range(n)
    ]
    hybrid = new_hybrid_search_index(
        FlatIndex(d, DistanceKind.L2), BM25SearchIndex(), RoaringMetadataIndex()
    )
    hybrid.vector_index().add_batch(corpus, ids=ids)
    hybrid._text.add_batch(ids.tolist(), texts)
    hybrid._metadata.add_batch(metas)
    hybrid._doc_info = {int(i): _DocInfo(True, True, True) for i in ids}
    return corpus, ids, texts, hybrid


def test_sharded_hybrid_matches_single_device(rng):
    """Sharded hybrid (metadata mask -> sharded vector scan -> BM25 ->
    fusion) returns HybridSearchIndex.search_batch's results exactly."""
    from comet_tpu.indexes.metadata import eq, gte
    from comet_tpu.types import FusionKind

    mesh = make_corpus_mesh()
    n, d, k = 2048, 16, 10
    corpus, ids, texts, hybrid = _build_hybrid_corpus(rng, n, d)

    vec_searcher = ShardedFlatSearcher(mesh, corpus, DistanceKind.L2, tile=256)
    sharded = ShardedHybridSearcher(
        vec_searcher, ids, text_index=hybrid._text, metadata_index=hybrid._metadata
    )

    queries = rng.normal(size=(5, d)).astype(np.float32)
    tq = ["w1 w2 w3", "w4 w5", "w6", "w7 w8", "w9"]
    for kwargs in (
        {},
        {"metadata_filters": [eq("cat", "a")]},
        {"metadata_filters": [eq("cat", "b"), gte("num", 10)],
         "fusion_kind": FusionKind.RECIPROCAL_RANK},
    ):
        want = hybrid.search_batch(queries, tq, k=k, **kwargs)
        got = sharded.search_batch(queries, tq, k=k, **kwargs)
        assert len(got) == len(want)
        for g_row, w_row in zip(got, want):
            assert [r.id for r in g_row] == [r.id for r in w_row]
            np.testing.assert_allclose(
                [r.score for r in g_row], [r.score for r in w_row],
                rtol=1e-5, atol=1e-6,
            )


def test_sharded_hybrid_modality_subsets(rng):
    """Vector-only (ascending), text-only, and metadata-only (score 1.0)
    semantics match the single-device coordinator."""
    from comet_tpu.indexes.metadata import eq

    mesh = make_corpus_mesh()
    n, d, k = 512, 8, 5
    corpus, ids, texts, hybrid = _build_hybrid_corpus(rng, n, d)
    vec_searcher = ShardedFlatSearcher(mesh, corpus, DistanceKind.L2, tile=64)
    sharded = ShardedHybridSearcher(
        vec_searcher, ids, text_index=hybrid._text, metadata_index=hybrid._metadata
    )
    queries = rng.normal(size=(2, d)).astype(np.float32)

    # vector-only: ascending distances
    want = hybrid.search_batch(queries, None, k=k)
    got = sharded.search_batch(queries, None, k=k)
    for g_row, w_row in zip(got, want):
        assert [r.id for r in g_row] == [r.id for r in w_row]
        assert all(
            g_row[i].score <= g_row[i + 1].score for i in range(len(g_row) - 1)
        )

    # text-only
    want = hybrid.search_batch(None, ["w1 w2", "w3"], k=k)
    got = sharded.search_batch(None, ["w1 w2", "w3"], k=k)
    for g_row, w_row in zip(got, want):
        assert [r.id for r in g_row] == [r.id for r in w_row]

    # metadata-only: all candidates score 1.0
    want = hybrid.search_batch(
        queries, None, k=k, metadata_filters=[eq("cat", "c")]
    )
    got = sharded.search_batch(
        queries, None, k=k, metadata_filters=[eq("cat", "c")]
    )
    for g_row, w_row in zip(got, want):
        assert [r.id for r in g_row] == [r.id for r in w_row]


def test_sharded_kmeans_step_matches_single_device(rng):
    mesh = make_corpus_mesh()
    n, d, k = 512, 8, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    centroids = x[:k].copy()
    prev = np.full(n, -1, dtype=np.int32)

    step = make_sharded_kmeans_step(mesh, DistanceKind.L2_SQUARED)
    xs, vs, ps = shard_rows(mesh, x, valid, prev)
    assign, new_c, changed = step(xs, vs, ps, centroids)

    # oracle: plain numpy assignment + update
    dist = distances_np(x, centroids, "l2_squared")
    want_assign = dist.argmin(axis=1)
    np.testing.assert_array_equal(np.asarray(assign), want_assign)
    for c in range(k):
        members = x[want_assign == c]
        if len(members):
            np.testing.assert_allclose(
                np.asarray(new_c)[c], members.mean(axis=0), rtol=1e-4, atol=1e-4
            )
    assert bool(changed)


def test_sharded_hnsw_matches_single_device(rng):
    """Query-sharded HNSW over a replicated graph returns the single-device
    index's results bit-for-bit (same beam kernel, same parameters)."""
    from comet_tpu.indexes.hnsw import HNSWConfig, HNSWIndex
    from comet_tpu.parallel.sharded import ShardedHNSWSearcher, make_corpus_mesh

    n, d = 600, 16
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.uint32)
    idx = HNSWIndex(d, DistanceKind.L2, HNSWConfig(m=8, ef_construction=48, ef_search=64))
    idx.add_batch(corpus, ids=ids.tolist())

    mesh = make_corpus_mesh()
    sharded = ShardedHNSWSearcher(mesh, idx)
    q = rng.normal(size=(24, d)).astype(np.float32)

    want_ids, want_sc = idx.search_batch(q, k=10)
    s, slots = sharded.search(q, k=10)
    got_ids = np.where(
        slots == 2**31 - 1, 0xFFFFFFFF, idx._store.ids[np.clip(slots, 0, n - 1)]
    ).astype(np.uint32)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(s, want_sc, rtol=1e-5, atol=1e-5)


def test_sharded_hnsw_allowed_and_uneven_batch(rng):
    """Odd query counts pad to the mesh; allowed masks gate results."""
    from comet_tpu.indexes.hnsw import HNSWConfig, HNSWIndex
    from comet_tpu.parallel.sharded import ShardedHNSWSearcher, make_corpus_mesh

    n, d = 300, 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    idx = HNSWIndex(d, DistanceKind.L2, HNSWConfig(m=8, ef_construction=48, ef_search=64))
    idx.add_batch(corpus, ids=list(range(1, n + 1)))

    mesh = make_corpus_mesh()
    sharded = ShardedHNSWSearcher(mesh, idx)
    q = rng.normal(size=(13, d)).astype(np.float32)  # not divisible by 8
    allowed = np.zeros(idx._store.capacity, dtype=bool)
    allowed[0:n:2] = True  # even slots only
    s, slots = sharded.search(q, k=5, allowed=allowed)
    assert s.shape == (13, 5)
    live = slots != 2**31 - 1
    assert live.any()
    assert (slots[live] % 2 == 0).all()


def test_sharded_ivfpq_opq_matches_single_device(rng):
    """OPQ rotation must stay internal under corpus sharding: the sharded
    scan rotates reconstructions and coarse centroids back to user space,
    so user-space queries return the same ids as the single-device index."""
    from comet_tpu.indexes.ivfpq import IVFPQIndex
    from comet_tpu.parallel.sharded import ShardedIVFPQSearcher
    from comet_tpu.types import DistanceKind

    n, dim = 900, 16
    base = rng.normal(size=(n, dim)).astype(np.float32)
    scalemat = np.diag(np.linspace(0.1, 2.0, dim).astype(np.float32))
    data = (base @ scalemat).astype(np.float32)
    idx = IVFPQIndex(dim, DistanceKind.L2, nlist=4, m=4, nbits=6, opq=True,
                     opq_iters=2)
    idx.train(data)
    idx.add_batch(data, ids=list(range(1, n + 1)))
    q = rng.normal(size=(16, dim)).astype(np.float32)
    single_ids, single_sc = idx.search_batch(q, k=10, nprobes=4)
    sh = ShardedIVFPQSearcher(make_corpus_mesh(), idx, tile=128)
    s, slots = sh.search(q, k=10, nprobe=4)
    got_ids = sh.row_ids[np.clip(slots, 0, n - 1)]
    np.testing.assert_array_equal(got_ids, single_ids)
    np.testing.assert_allclose(s, single_sc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1000, 8 * 125 + 3])
def test_sharded_ivf_shard_not_a_tile_multiple(rng, n):
    """Rows per device that the scan tile does not divide (1M rows per card
    with a 16k tile on four cards) pad up to a tile multiple instead of
    failing the tile reshape."""
    from comet_tpu.indexes.ivf import IVFIndex
    from comet_tpu.parallel.sharded import padded_shard

    mesh = make_corpus_mesh()
    d = 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(5, d)).astype(np.float32)
    idx = IVFIndex(d, 8, DistanceKind.L2)
    idx.train(corpus)
    idx.add_batch(corpus, ids=np.arange(1, n + 1, dtype=np.uint32))
    shard, tile = padded_shard(n, 8, 48)
    assert shard % tile == 0 and shard * 8 >= n
    sharded = ShardedIVFSearcher(mesh, idx, tile=48)
    want_ids, _ = idx.search_batch(queries, k=10, nprobes=3)
    _, slots = sharded.search(queries, 10, nprobe=3)
    np.testing.assert_array_equal(
        sharded.row_ids[np.clip(slots, 0, n - 1)], want_ids
    )
