"""Seeded pure-XLA beam (ops/graph.beam_search_layer0 seed_d/seed_s/stop)
and the two-stage sharded seeded-HNSW searcher (parallel/sharded).

The seeded beam is the HNSW index's default search at n >= 32k
(indexes/hnsw._search_launch): the beam initializes from an IVF cluster-
probe scan and terminates on the k-window bound. Contracts tested here:
seeds flow into results verbatim (metric domain), empty seed rows fall back
to the entry point, the stop window cannot lose admitted seeds, and the
sharded two-stage pipeline is shard-count-invariant."""

import jax.numpy as jnp
import numpy as np
import pytest

import jax

from comet_tpu.indexes.hnsw import HNSWConfig, HNSWIndex
from comet_tpu.ops.graph import beam_search_layer0
from comet_tpu.ops.topk import IDX_SENTINEL
from comet_tpu.parallel.sharded import (
    ShardedSeededHNSWSearcher,
    make_corpus_mesh,
)
from comet_tpu.types import DistanceKind

from oracle import distances_np

SENT = int(IDX_SENTINEL)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    return rng.normal(size=(1024, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(22)
    return rng.normal(size=(8, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def graph(corpus):
    """A small layer-0 graph: exact 8-NN adjacency (symmetric enough for
    beam traversal) + device arrays."""
    d = distances_np(corpus, corpus, "l2")
    np.fill_diagonal(d, np.inf)
    adj = np.argsort(d, axis=1)[:, :8].astype(np.int32)
    sqn = (corpus * corpus).sum(axis=1).astype(np.float32)
    return (
        jnp.asarray(adj),
        jnp.asarray(corpus),
        jnp.asarray(sqn),
        jnp.ones(len(corpus), bool),
    )


def _oracle_topk(queries, corpus, k):
    d = distances_np(queries, corpus, "l2")
    order = np.lexsort(
        (np.broadcast_to(np.arange(d.shape[1]), d.shape), d), axis=1
    )
    idx = order[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


def test_seeded_beam_exact_seeds_pass_through(corpus, queries, graph):
    """Perfect seeds (the oracle top-ef) must yield the exact top-k: every
    seed is admitted into the results verbatim, so no beam expansion can
    improve on them."""
    adj, vecs, sqn, allowed = graph
    ef = 32
    sd, ss = _oracle_topk(queries, corpus, ef)
    rd, rs = beam_search_layer0(
        jnp.asarray(queries), jnp.zeros(len(queries), jnp.int32),
        adj, vecs, sqn, allowed, jnp.asarray(np.float32(np.inf)),
        ef, 10, DistanceKind.L2, 8, expand=4, fused_results=True,
        seed_d=jnp.asarray(sd.astype(np.float32)),
        seed_s=jnp.asarray(ss.astype(np.int32)),
        stop=16,
    )
    want_d, want_s = _oracle_topk(queries, corpus, 10)
    np.testing.assert_array_equal(np.asarray(rs), want_s)
    np.testing.assert_allclose(np.asarray(rd), want_d, rtol=1e-5, atol=1e-5)


def test_seeded_beam_narrow_seed_block_pads(corpus, queries, graph):
    """A seed block narrower than ef pads internally (the sharded searcher
    hands the beam a stop-width block)."""
    adj, vecs, sqn, allowed = graph
    sd, ss = _oracle_topk(queries, corpus, 8)
    rd, rs = beam_search_layer0(
        jnp.asarray(queries), jnp.zeros(len(queries), jnp.int32),
        adj, vecs, sqn, allowed, jnp.asarray(np.float32(np.inf)),
        32, 8, DistanceKind.L2, 16, expand=4, fused_results=True,
        seed_d=jnp.asarray(sd.astype(np.float32)),
        seed_s=jnp.asarray(ss.astype(np.int32)),
        stop=16,
    )
    want_d, want_s = _oracle_topk(queries, corpus, 8)
    np.testing.assert_array_equal(np.asarray(rs), want_s)


def test_seeded_beam_empty_rows_fall_back_to_entry(corpus, queries, graph):
    """Queries whose seed row is empty start from the entry point — results
    must match the unseeded beam exactly (same entry, same ef bound when
    stop == ef)."""
    adj, vecs, sqn, allowed = graph
    ef, k = 32, 10
    entry = jnp.full(len(queries), 3, jnp.int32)
    empty_d = jnp.full((len(queries), ef), np.inf, jnp.float32)
    empty_s = jnp.full((len(queries), ef), SENT, jnp.int32)
    seeded = beam_search_layer0(
        jnp.asarray(queries), entry, adj, vecs, sqn, allowed,
        jnp.asarray(np.float32(np.inf)), ef, k, DistanceKind.L2, 64,
        expand=4, fused_results=True,
        seed_d=empty_d, seed_s=empty_s, stop=ef,
    )
    plain = beam_search_layer0(
        jnp.asarray(queries), entry, adj, vecs, sqn, allowed,
        jnp.asarray(np.float32(np.inf)), ef, k, DistanceKind.L2, 64,
        expand=4, fused_results=True,
    )
    np.testing.assert_array_equal(np.asarray(seeded[1]), np.asarray(plain[1]))
    np.testing.assert_allclose(
        np.asarray(seeded[0]), np.asarray(plain[0]), rtol=1e-6, atol=1e-6
    )


@pytest.fixture(scope="module")
def hnsw_index(corpus):
    idx = HNSWIndex(
        16, DistanceKind.L2, HNSWConfig(m=8, ef_construction=48, ef_search=64)
    )
    idx.add_batch(corpus, ids=list(range(1, len(corpus) + 1)))
    return idx


@pytest.fixture(scope="module")
def seed_centroids(corpus):
    from comet_tpu.ops.kmeans import kmeans

    c, _ = kmeans(corpus, 32, DistanceKind.L2_SQUARED, 10, return_assign=False)
    return np.asarray(c)


def test_sharded_seeded_shard_count_invariance(
    corpus, queries, hnsw_index, seed_centroids
):
    """Identical (scores, slots) — tie order included — on 1/2/4/8 shards
    with shared seed centroids: stage 1's all_gather merge and stage 2's
    per-query beam are both shard-layout-independent."""
    runs = []
    for s in (1, 2, 4, 8):
        searcher = ShardedSeededHNSWSearcher(
            make_corpus_mesh(jax.devices()[:s]), hnsw_index,
            centroids=seed_centroids, nprobe=4,
        )
        runs.append(searcher.search(queries, k=10))
    ref_d, ref_s = runs[0]
    for d, sl in runs[1:]:
        np.testing.assert_array_equal(sl, ref_s)
        np.testing.assert_allclose(d, ref_d, rtol=1e-5, atol=1e-5)


def test_sharded_seeded_recall_vs_oracle(
    corpus, queries, hnsw_index, seed_centroids
):
    """Seeds are true near-neighbors, so recall@10 must be high even with a
    modest probe count at this scale."""
    searcher = ShardedSeededHNSWSearcher(
        make_corpus_mesh(jax.devices()), hnsw_index,
        centroids=seed_centroids, nprobe=8,
    )
    d, slots = searcher.search(queries, k=10)
    _, want = _oracle_topk(queries, corpus, 10)
    hits = sum(
        len(set(slots[i].tolist()) & set(want[i].tolist()))
        for i in range(len(queries))
    )
    assert hits / want.size >= 0.9


def test_sharded_seeded_allowed_mask(corpus, queries, hnsw_index, seed_centroids):
    """A slot-mask filter gates result admission: every returned slot obeys
    the mask, and results match the masked oracle's top hits closely."""
    mask = np.zeros(len(corpus), bool)
    mask[::3] = True
    searcher = ShardedSeededHNSWSearcher(
        make_corpus_mesh(jax.devices()), hnsw_index,
        centroids=seed_centroids, nprobe=8,
    )
    d, slots = searcher.search(queries, k=10, allowed=mask)
    live = slots != SENT
    assert live.any()
    assert mask[slots[live]].all()
