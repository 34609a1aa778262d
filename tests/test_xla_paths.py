"""The plain-XLA search paths against the numpy oracle.

These paths serve every device: the flat block-select scan (ops/topk), the
IVF and IVFPQ list walks (indexes/ivf, indexes/ivfpq), the IVFPQ exact
re-rank, the HNSW seed scan and lockstep beam (ops/graph), and the staged
device kNN of the HNSW bulk build (ops/graph_build). Exactness includes the
(score asc, slot asc) tie order.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from comet_tpu.indexes.flat import FlatIndex
from comet_tpu.indexes.hnsw import HNSWConfig, HNSWIndex
from comet_tpu.indexes.ivf import IVFIndex, build_chunked_lists
from comet_tpu.indexes.ivfpq import IVFPQIndex
from comet_tpu.ops.graph import beam_search_layer0, nearest_entry
from comet_tpu.ops.topk import IDX_SENTINEL, block_select_from_dist, block_topk
from comet_tpu.types import DistanceKind

from oracle import distances_np, preprocess_np, topk_np

SENT = int(IDX_SENTINEL)
INF32 = np.float32(np.inf)


def _ids_of(slots):
    """Oracle rows -> doc ids (ids are rows + 1), -1 stays 0xFFFFFFFF."""
    return np.where(slots >= 0, slots + 1, 0xFFFFFFFF).astype(np.uint32)


# -- flat: block select -------------------------------------------------------


@pytest.mark.parametrize("k", [1, 10, 100])
def test_flat_matches_oracle(rng, k):
    data = rng.normal(size=(3000, 32)).astype(np.float32)
    q = rng.normal(size=(40, 32)).astype(np.float32)
    idx = FlatIndex(32, DistanceKind.L2)
    idx.add_batch(data, ids=np.arange(1, 3001))
    ids, scores = idx.search_batch(q, k=k)
    want_s, want_i = topk_np(distances_np(q, data, "l2"), k)
    np.testing.assert_array_equal(ids, _ids_of(want_i))
    np.testing.assert_allclose(scores, want_s, rtol=1e-4, atol=1e-3)


def test_block_topk_threshold(rng):
    data = rng.normal(size=(2048, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    d = distances_np(q, data, "l2_squared")
    thr = np.float32(np.quantile(d, 0.01))
    s, i = block_topk(
        jnp.asarray(q), jnp.asarray(data), jnp.asarray((data * data).sum(1)),
        jnp.ones(2048, bool), jnp.asarray(thr), 50, DistanceKind.L2_SQUARED,
        super_tile=512,
    )
    want_s, want_i = topk_np(d, 50, threshold=thr)
    got_i = np.where(np.asarray(i) == SENT, -1, np.asarray(i))
    np.testing.assert_array_equal(got_i, want_i)
    assert np.all(np.asarray(s)[got_i >= 0] <= thr)


def test_block_topk_threshold_empties(rng):
    """A threshold no row meets returns only (inf, sentinel) slots."""
    data = rng.normal(size=(1024, 8)).astype(np.float32) + 100.0
    q = np.zeros((4, 8), np.float32)
    s, i = block_topk(
        jnp.asarray(q), jnp.asarray(data), jnp.asarray((data * data).sum(1)),
        jnp.ones(1024, bool), jnp.asarray(np.float32(1.0)), 10,
        DistanceKind.L2_SQUARED, super_tile=256,
    )
    assert np.isinf(np.asarray(s)).all()
    assert (np.asarray(i) == SENT).all()


def test_flat_cosine_multichunk(rng):
    """Cosine over more queries than one dispatch chunk (256) and a corpus
    of several scan tiles."""
    data = rng.normal(size=(5000, 24)).astype(np.float32)
    q = rng.normal(size=(300, 24)).astype(np.float32)
    idx = FlatIndex(24, DistanceKind.COSINE)
    idx.add_batch(data, ids=np.arange(1, 5001))
    ids, _ = idx.search_batch(q, k=10)
    want_s, want_i = topk_np(
        distances_np(preprocess_np(q, "cosine"), preprocess_np(data, "cosine"),
                     "cosine"), 10,
    )
    agree = np.mean(ids == _ids_of(want_i))
    assert agree > 0.999  # cosine near-ties may swap at f32 rounding


def test_flat_doc_filter_matches_masked_oracle(rng):
    data = rng.normal(size=(2000, 16)).astype(np.float32)
    q = rng.normal(size=(16, 16)).astype(np.float32)
    idx = FlatIndex(16, DistanceKind.L2)
    idx.add_batch(data, ids=np.arange(1, 2001))
    keep = np.arange(2000) % 7 == 3
    ids, _ = idx.search_batch(q, k=12, document_ids=np.flatnonzero(keep) + 1)
    _, want_i = topk_np(distances_np(q, data, "l2"), 12, mask=keep[None, :])
    np.testing.assert_array_equal(ids, _ids_of(want_i))


def test_block_select_tie_order_is_slot_ascending():
    """Exact ties across and within groups resolve to ascending slot."""
    dist = np.full((3, 1024), 5.0, np.float32)
    dist[:, ::97] = 1.0            # ties spread over many groups
    dist[1, 500:520] = 0.5          # a tied run inside one group
    s, i = block_select_from_dist(jnp.asarray(dist), 30, 128, 0)
    s, i = np.asarray(s), np.asarray(i)
    order = np.lexsort((np.broadcast_to(np.arange(1024), dist.shape), dist),
                       axis=1)[:, :30]
    np.testing.assert_array_equal(i, order)
    np.testing.assert_array_equal(s, np.take_along_axis(dist, order, axis=1))


# -- IVF: the list walk --------------------------------------------------------


def _ivf(rng, n=3000, d=16, nlist=16, kind=DistanceKind.L2):
    data = rng.normal(size=(n, d)).astype(np.float32)
    idx = IVFIndex(d, nlist, kind)
    idx.train(data)
    idx.add_batch(data, ids=np.arange(1, n + 1))
    return idx, data


def _probe_mask(idx, qp, nprobe, kind):
    cd = distances_np(qp, idx._centroids, kind)
    probes = np.argsort(cd, axis=1, kind="stable")[:, :nprobe]
    n = idx._store.n
    return np.stack([np.isin(idx._assign[:n], p) for p in probes])


@pytest.mark.parametrize("nprobe", [2, 5])
def test_ivf_matches_probe_masked_oracle(rng, nprobe):
    idx, data = _ivf(rng)
    q = rng.normal(size=(24, 16)).astype(np.float32)
    ids, scores = idx.search_batch(q, k=10, nprobes=nprobe)
    mask = _probe_mask(idx, q, nprobe, "l2")
    want_s, want_i = topk_np(distances_np(q, data, "l2"), 10, mask=mask)
    np.testing.assert_array_equal(ids, _ids_of(want_i))
    np.testing.assert_allclose(scores, want_s, rtol=1e-4, atol=1e-3)


def test_ivf_filter_and_threshold(rng):
    idx, data = _ivf(rng)
    q = rng.normal(size=(12, 16)).astype(np.float32)
    keep = np.arange(len(data)) % 3 == 0
    d = distances_np(q, data, "l2")
    thr = float(np.quantile(d, 0.2))
    ids, _ = idx.search_batch(q, k=20, nprobes=6, threshold=thr,
                              document_ids=np.flatnonzero(keep) + 1)
    mask = _probe_mask(idx, q, 6, "l2") & keep[None, :]
    _, want_i = topk_np(d, 20, mask=mask, threshold=thr)
    np.testing.assert_array_equal(ids, _ids_of(want_i))


def test_ivf_cosine_matches_probe_masked_oracle(rng):
    idx, data = _ivf(rng, kind=DistanceKind.COSINE)
    q = rng.normal(size=(16, 16)).astype(np.float32)
    qp, xp = preprocess_np(q, "cosine"), preprocess_np(data, "cosine")
    ids, _ = idx.search_batch(q, k=10, nprobes=4)
    mask = _probe_mask(idx, qp, 4, "cosine")
    _, want_i = topk_np(distances_np(qp, xp, "cosine"), 10, mask=mask)
    assert np.mean(ids == _ids_of(want_i)) > 0.995


def test_ivf_query_batches_beyond_one_dispatch(rng):
    """More queries than IVF_QUERY_CHUNK split into several dispatches with
    the same per-row results as one query at a time."""
    idx, data = _ivf(rng)
    q = rng.normal(size=(300, 16)).astype(np.float32)
    ids, _ = idx.search_batch(q, k=5, nprobes=3)
    one, _ = idx.search_batch(q[[0, 150, 299]], k=5, nprobes=3)
    np.testing.assert_array_equal(ids[[0, 150, 299]], one)


def test_ivf_skewed_list_walk_is_exact(rng):
    """One list holding most rows needs many 256-row chunks; the cursor
    walk must visit all of them (no step budget cuts it short)."""
    n, d = 4000, 8
    data = rng.normal(size=(n, d)).astype(np.float32) * 0.01
    data[:200] += 50.0                   # a small far cluster
    idx = IVFIndex(d, 4, DistanceKind.L2)
    idx.train(data)
    idx.add_batch(data, ids=np.arange(1, n + 1))
    counts = np.bincount(idx._assign[:n], minlength=4)
    assert counts.max() > 3 * 256
    q = data[200:208] + 0.001
    ids, _ = idx.search_batch(q, k=10, nprobes=1)
    mask = _probe_mask(idx, q, 1, "l2")
    _, want_i = topk_np(distances_np(q, data, "l2"), 10, mask=mask)
    np.testing.assert_array_equal(ids, _ids_of(want_i))


def test_chunked_lists_layout():
    """Every assigned slot appears exactly once, in its list's chunk range,
    ascending within the list; unassigned (-1) slots appear nowhere."""
    rng = np.random.default_rng(3)
    assign = rng.integers(-1, 7, size=2000).astype(np.int32)
    slots, start, max_chunks = build_chunked_lists(assign, 7, chunk=64)
    for c in range(7):
        rows = slots[start[c]:start[c + 1]].ravel()
        rows = rows[rows >= 0]
        np.testing.assert_array_equal(rows, np.flatnonzero(assign == c))
        assert start[c + 1] - start[c] <= max_chunks
    listed = slots[slots >= 0]
    assert len(listed) == len(np.unique(listed)) == (assign >= 0).sum()


def test_chunked_lists_empty_and_single():
    slots, start, max_chunks = build_chunked_lists(
        np.full(10, -1, np.int32), 3
    )
    assert (slots == -1).all() and (start == 0).all() and max_chunks == 1
    slots, start, _ = build_chunked_lists(np.zeros(5, np.int32), 1, chunk=4)
    np.testing.assert_array_equal(slots[:2].ravel()[:5], np.arange(5))
    np.testing.assert_array_equal(start, [0, 2])


# -- IVFPQ: the LUT walk and the exact re-rank --------------------------------


def _ivfpq(rng, n=2000, d=16):
    data = rng.normal(size=(n, d)).astype(np.float32)
    idx = IVFPQIndex(d, DistanceKind.L2, nlist=8, m=4, nbits=6,
                     store_originals=True)
    idx.train(data)
    idx.add_batch(data, ids=np.arange(1, n + 1))
    return idx, data


def _adc_oracle(idx, q, nprobe):
    """Float64 residual-ADC distances over the probed lists (inf elsewhere)."""
    n = idx._store.n
    cents = idx._centroids.astype(np.float64)
    cb = idx._codebooks.astype(np.float64)
    m, _, dsub = cb.shape
    codes = idx._codes[:n]
    assign = idx._assign[:n]
    out = np.full((len(q), n), np.inf)
    for qi, qv in enumerate(q.astype(np.float64)):
        cd = ((cents - qv) ** 2).sum(1)
        for c in np.argsort(cd, kind="stable")[:nprobe]:
            rows = np.flatnonzero(assign == c)
            r = qv - cents[c]
            acc = np.zeros(len(rows))
            for j in range(m):
                lut = ((r[j * dsub:(j + 1) * dsub] - cb[j]) ** 2).sum(1)
                acc += lut[codes[rows, j]]
            out[qi, rows] = acc
    return out


def test_ivfpq_matches_adc_oracle(rng):
    idx, _ = _ivfpq(rng)
    q = rng.normal(size=(10, 16)).astype(np.float32)
    ids, scores = idx.search_batch(q, k=10, nprobes=3)
    want = _adc_oracle(idx, q, 3)
    want_s, want_i = topk_np(want, 10)
    np.testing.assert_array_equal(ids, _ids_of(want_i))
    np.testing.assert_allclose(scores, np.sqrt(want_s), rtol=1e-4, atol=1e-4)


def test_ivfpq_nrefine_reranks_the_adc_shortlist(rng):
    idx, data = _ivfpq(rng)
    q = rng.normal(size=(10, 16)).astype(np.float32)
    ids, scores = idx.search_batch(q, k=5, nprobes=3, nrefine=40)
    adc = _adc_oracle(idx, q, 3)
    exact = distances_np(q, data, "l2", dtype=np.float64)
    for qi in range(len(q)):
        short = np.lexsort((np.arange(adc.shape[1]), adc[qi]))[:40]
        best = short[np.lexsort((short, exact[qi, short]))][:5]
        np.testing.assert_array_equal(ids[qi], best + 1)
        np.testing.assert_allclose(scores[qi], exact[qi, best], rtol=1e-4)


# -- HNSW: seed scan, beam, entry selection -----------------------------------


@pytest.fixture(scope="module")
def small_graph():
    """Exact 10-NN layer-0 adjacency over 512 points + device arrays (the
    beam's packed visited bitmask needs a multiple of 32 rows, which an
    index's power-of-two capacity always is)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(512, 12)).astype(np.float32)
    d = distances_np(x, x, "l2")
    np.fill_diagonal(d, np.inf)
    adj = np.argsort(d, axis=1)[:, :10].astype(np.int32)
    return x, (jnp.asarray(adj), jnp.asarray(x),
               jnp.asarray((x * x).sum(1)))


def _beam(small_graph, q, allowed=None, thr=INF32, ef=64, k=10, **kw):
    x, (adj, vecs, sqn) = small_graph
    allowed = jnp.ones(len(x), bool) if allowed is None else allowed
    return beam_search_layer0(
        jnp.asarray(q), jnp.zeros(len(q), jnp.int32), adj, vecs, sqn, allowed,
        jnp.asarray(thr), ef, k, DistanceKind.L2, 400, **kw,
    )


def test_beam_full_search_small_graph_exact(small_graph):
    """With ef covering the graph's reach, the beam returns the exact top-k
    in (score, slot) order."""
    x, _ = small_graph
    q = np.random.default_rng(6).normal(size=(6, 12)).astype(np.float32)
    s, i = _beam(small_graph, q, ef=256, fused_results=False)
    want_s, want_i = topk_np(distances_np(q, x, "l2"), 10)
    np.testing.assert_array_equal(np.asarray(i), want_i)
    np.testing.assert_allclose(np.asarray(s), want_s, rtol=1e-5, atol=1e-5)


def test_beam_fused_filter_admits_only_allowed(small_graph):
    """Filtered nodes route traversal but never enter results; with a wide
    beam the filtered top-k equals the masked oracle."""
    x, _ = small_graph
    q = np.random.default_rng(7).normal(size=(6, 12)).astype(np.float32)
    keep = np.arange(len(x)) % 4 == 1
    s, i = _beam(small_graph, q, allowed=jnp.asarray(keep), ef=256,
                 fused_results=True)
    _, want_i = topk_np(distances_np(q, x, "l2"), 10, mask=keep[None, :])
    np.testing.assert_array_equal(np.asarray(i), want_i)


def test_beam_seeded_fused_filter(small_graph):
    """Seeds that are filtered out still route; admitted seeds surface."""
    x, _ = small_graph
    q = np.random.default_rng(8).normal(size=(5, 12)).astype(np.float32)
    d = distances_np(q, x, "l2")
    keep = np.arange(len(x)) % 2 == 0
    seed_i = np.argsort(d, axis=1, kind="stable")[:, :16].astype(np.int32)
    seed_d = np.take_along_axis(d, seed_i, axis=1).astype(np.float32)
    s, i = _beam(small_graph, q, allowed=jnp.asarray(keep), ef=128,
                 fused_results=True, seed_d=jnp.asarray(seed_d),
                 seed_s=jnp.asarray(seed_i), stop=64)
    _, want_i = topk_np(d, 10, mask=keep[None, :])
    np.testing.assert_array_equal(np.asarray(i), want_i)


def test_beam_threshold_gates_results(small_graph):
    x, _ = small_graph
    q = np.random.default_rng(9).normal(size=(4, 12)).astype(np.float32)
    d = distances_np(q, x, "l2")
    thr = np.float32(np.sort(d, axis=1)[:, 4].min())
    s, i = _beam(small_graph, q, thr=thr, ef=256, fused_results=True)
    s, i = np.asarray(s), np.asarray(i)
    assert np.all(s[i != SENT] <= thr)
    _, want_i = topk_np(d, 10, threshold=thr)
    np.testing.assert_array_equal(np.where(i == SENT, -1, i), want_i)


def test_nearest_entry_picks_the_nearest_member(rng):
    mem = rng.normal(size=(50, 16)).astype(np.float32)
    slots = np.arange(100, 150, dtype=np.int32)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    got = nearest_entry(
        jnp.asarray(q), jnp.asarray(mem.T).astype(jnp.bfloat16),
        jnp.asarray((mem * mem).sum(1)), jnp.asarray(slots),
    )
    d = distances_np(q, mem, "l2")
    best = np.sort(d, axis=1)
    got_d = d[np.arange(20), np.asarray(got) - 100]
    # bf16 products: the pick is the nearest up to bf16 rounding
    assert np.all(got_d <= best[:, 0] * 1.02 + 1e-3)


@pytest.fixture(scope="module")
def seeded_index(monkeypatch_module):
    import comet_tpu.indexes.hnsw as hnsw_mod

    monkeypatch_module.setattr(hnsw_mod, "SEED_MIN_N", 512)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1500, 16)).astype(np.float32)
    idx = HNSWIndex(16, DistanceKind.L2, HNSWConfig(m=8, ef_construction=64))
    idx.add_batch(x, ids=np.arange(1, 1501))
    assert idx._use_seed()
    return idx, x


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_seed_scan_matches_probe_masked_oracle(seeded_index):
    """The seed scan is the IVF list walk over the seed cells: exact top-k
    of the probed cells, metric-space distances."""
    idx, x = seeded_index
    q = np.random.default_rng(12).normal(size=(8, 16)).astype(np.float32)
    sd, ss = idx._seed_scan(jnp.asarray(q), 16)
    st = idx._ensure_seed()
    nprobe = max(2, st["nlist"] // 64)
    cd = distances_np(q, idx._seed_centroids, "l2_squared")
    probes = np.argsort(cd, axis=1, kind="stable")[:, :nprobe]
    mask = np.stack([np.isin(idx._seed_assign[:1500], p) for p in probes])
    want_s, want_i = topk_np(distances_np(q, x, "l2"), 16, mask=mask)
    np.testing.assert_array_equal(np.where(np.asarray(ss) == SENT, -1,
                                           np.asarray(ss)), want_i)
    np.testing.assert_allclose(np.asarray(sd), want_s, rtol=1e-4, atol=1e-4)


def test_seeded_index_search_recall(seeded_index):
    idx, x = seeded_index
    q = np.random.default_rng(13).normal(size=(32, 16)).astype(np.float32)
    ids, scores = idx.search_batch(q, k=10, ef_search=64)
    _, want_i = topk_np(distances_np(q, x, "l2"), 10)
    hits = np.mean([len(np.intersect1d(a, b + 1)) / 10
                    for a, b in zip(ids, want_i)])
    assert hits >= 0.9
    assert np.all(np.diff(scores, axis=1) >= 0)


def test_seeded_index_filter_returns_only_allowed(seeded_index):
    idx, x = seeded_index
    q = np.random.default_rng(14).normal(size=(8, 16)).astype(np.float32)
    allowed = np.arange(1, 1501)[np.arange(1500) % 5 == 0]
    ids, _ = idx.search_batch(q, k=10, ef_search=64, document_ids=allowed)
    assert np.isin(ids[ids != 0xFFFFFFFF], allowed).all()
    assert (ids != 0xFFFFFFFF).sum(axis=1).min() == 10


# -- HNSW bulk build: the device kNN stages ----------------------------------


def test_bulk_build_device_knn_matches_host_knn(monkeypatch):
    """The device kNN stages (block top-k against the member prefix) build
    the same layer as the host matmul path. Regression: a pooled host query
    buffer refilled while an earlier stage was still pending gave that
    stage another chunk's queries."""
    import comet_tpu.ops.graph_build as gb

    rng = np.random.default_rng(15)
    n = 5000
    vec = np.zeros((8192, 16), np.float32)
    vec[:n] = rng.normal(size=(n, 16))
    out = {}
    for mode, host_max in (("host", 10**9), ("device", 2048)):
        monkeypatch.setattr(gb, "HOST_KNN_MAX", host_max)
        monkeypatch.setattr(gb, "QUERY_CHUNK", 1024)
        b = gb.BulkGraphBuilder(vec, n, DistanceKind.L2)
        out[mode] = b.build_layer(None, 8, 16)[:n]
    np.testing.assert_array_equal(out["device"], out["host"])
