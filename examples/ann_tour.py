"""Tour of the five vector index types and their accuracy/speed levers.

A reference (wizenheimer/comet) user switching over finds every index and
knob here, plus the batch-first extras: `search_batch`/`search_stream`
throughput APIs, device-fused `with_nrefine`, the OPQ rotation, seeded
HNSW, and exact per-structure memory accounting.

Run: python examples/ann_tour.py        (works on CPU or GPU)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from comet_tpu import DistanceKind, FlatIndex, HNSWIndex
from comet_tpu.indexes.hnsw import HNSWConfig
from comet_tpu.indexes.ivf import IVFIndex
from comet_tpu.indexes.ivfpq import IVFPQIndex
from comet_tpu.indexes.pq import PQIndex

N, DIM, K = 20_000, 64, 10
rng = np.random.default_rng(0)
corpus = rng.integers(0, 256, size=(N, DIM)).astype(np.float32)  # SIFT-like
queries = corpus[:256] + rng.normal(0, 4, size=(256, DIM)).astype(np.float32)
ids = np.arange(1, N + 1, dtype=np.uint32)


def show(name, idx, t_build, **search_kw):
    t0 = time.perf_counter()
    found, scores = idx.search_batch(queries, k=K, **search_kw)
    dt = time.perf_counter() - t0
    r = (found[:, 0] == np.arange(1, 257)).mean()
    mem = idx.stats().get("memory", {})
    print(
        f"{name:28s} build {t_build:6.2f}s   search {dt * 1e3:7.1f} ms"
        f"   top1-self {r:.2f}   host {mem.get('host_total', 0) / 1e6:7.1f} MB"
        f"   device {mem.get('device_total', 0) / 1e6:7.1f} MB"
    )
    return found


# 1. Flat: exact, the oracle every other index is measured against.
t0 = time.perf_counter()
flat = FlatIndex(DIM, DistanceKind.L2)
flat.add_batch(corpus, ids=ids)
truth = show("flat (exact)", flat, time.perf_counter() - t0)


def recall(found):
    return np.mean([
        len(set(f.tolist()) & set(t.tolist())) / K
        for f, t in zip(found, truth)
    ])


# 2. IVF: k-means partition; nprobe trades recall for speed.
t0 = time.perf_counter()
ivf = IVFIndex(DIM, 64, DistanceKind.L2)
ivf.train(corpus[:10_000])
ivf.add_batch(corpus, ids=ids)
f = show("ivf (nprobe=8)", ivf, time.perf_counter() - t0, nprobes=8)
print(f"{'':28s} recall@10 vs flat oracle: {recall(f):.3f}")

# 3. PQ: 16x compression; OPQ rotation recovers split-induced recall loss.
t0 = time.perf_counter()
pq = PQIndex(DIM, DistanceKind.L2, m=8, nbits=8, opq=True, opq_iters=3)
pq.train(corpus[:10_000])
pq.add_batch(corpus, ids=ids)
f = show("pq (m=8, OPQ)", pq, time.perf_counter() - t0)
print(f"{'':28s} recall@10 vs flat oracle: {recall(f):.3f}")

# 4. IVFPQ: coarse partition + residual codes; with_nrefine re-ranks the
# ADC shortlist with exact distances fused on device.
t0 = time.perf_counter()
ivfpq = IVFPQIndex(DIM, DistanceKind.L2, nlist=64, m=8,
                   store_originals=True, opq=True, opq_iters=3)
ivfpq.train(corpus[:10_000])
ivfpq.add_batch(corpus, ids=ids)
f = show("ivfpq (OPQ + nrefine=64)", ivfpq, time.perf_counter() - t0,
         nprobes=16, nrefine=64)
print(f"{'':28s} recall@10 vs flat oracle: {recall(f):.3f}")

# 5. HNSW: graph ANN; at >= 32k vectors the beam starts from an IVF probe scan.
t0 = time.perf_counter()
hnsw = HNSWIndex(DIM, DistanceKind.L2, HNSWConfig(m=16, ef_construction=128))
hnsw.add_batch(corpus, ids=ids)
f = show("hnsw (seeded beam)", hnsw, time.perf_counter() - t0, ef_search=128)
print(f"{'':28s} recall@10 vs flat oracle: {recall(f):.3f}")

# Fluent single-query API (identical semantics to the reference's):
res = (
    hnsw.new_search()
    .with_query(corpus[41])
    .with_k(3)
    .execute()
)
print("\nfluent top-3 for doc 42's vector:",
      [(r.node.id, round(float(r.score), 2)) for r in res])
