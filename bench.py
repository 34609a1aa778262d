"""Benchmarks vs the reference's published numbers (BASELINE.md).

Default run: the headline metric — flat exact-scan QPS on SIFT1M-shape data
(1M x 128-d, L2, k=100; reference: 22 QPS single-core Go on Apple M2 Pro,
docs/INDEX.md:694-700) — printed as ONE JSON line on stdout:
    {"metric", "value", "unit", "vs_baseline"}

`python bench.py --all` additionally benchmarks IVF / PQ / IVFPQ / HNSW /
BM25 / metadata / hybrid with recall@10 against the exact oracle, printing a
table to stderr.

Needs an NVIDIA GPU: every result names the device it ran on (JAX platform,
device kind and count, the card's name and power limit), and the script
exits non-zero when JAX's default device is not a GPU.
"""

import json
import os
import sys
import time

import numpy as np

# Persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR when set, else
# one fixed directory in the checkout.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))
import jax  # noqa: E402

jax.config.update("jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

N = 1_000_000
DIM = 128
K = 100
BATCH = 2048
ROUNDS = 4
BASELINE_FLAT_QPS = 22.0
IDS = None  # set in main(): consistent 1..N ids across all indexes
GT = None   # ground-truth neighbor ids [BATCH, >=100] when a real dataset
            # provides them (SIFT1M .ivecs); else flat-oracle truth


_LOG_FILE = None


def log(msg):
    print(msg, file=sys.stderr, flush=True)
    global _LOG_FILE
    if _LOG_FILE is None and os.environ.get("COMET_BENCH_LOG"):
        _LOG_FILE = open(os.environ["COMET_BENCH_LOG"], "a", buffering=1)
        _LOG_FILE.write(f"# bench session {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
    if _LOG_FILE is not None:
        _LOG_FILE.write(msg + "\n")


def gen_data(n=N, dim=DIM, seed=0):
    """SIFT-like clustered corpus: a Gaussian mixture rather than uniform
    noise (uniform high-dim data has no neighborhood structure, which makes
    every ANN method look artificially bad; real descriptor datasets are
    strongly clustered)."""
    rng = np.random.default_rng(seed)
    n_centers = 1024
    intrinsic = 16  # real descriptor sets have low intrinsic dimension
    centers = rng.uniform(0, 256, size=(n_centers, dim)).astype(np.float32)
    proj = rng.normal(scale=1.0, size=(intrinsic, dim)).astype(np.float32)

    def sample(count):
        which = rng.integers(0, n_centers, size=count)
        z = rng.normal(scale=12.0, size=(count, intrinsic)).astype(np.float32)
        return (centers[which] + z @ proj).astype(np.float32)

    return sample(n), sample(BATCH)


def load_data():
    """Real dataset when COMET_DATASET_DIR points at a texmex-style dir
    (SIFT1M: sift_base.fvecs / sift_query.fvecs / sift_groundtruth.ivecs);
    synthetic clustered fallback otherwise. Returns (corpus, queries, gt)
    where gt is [Q, >=100] int32 0-based row ids or None."""
    global N, DIM
    d = os.environ.get("COMET_DATASET_DIR")
    if d:
        from comet_tpu.io.datasets import load_sift_dir

        base, queries, gt = load_sift_dir(d, max_queries=BATCH)
        N, DIM = base.shape
        log(f"dataset: {d} ({N} x {DIM}, {len(queries)} queries, "
            f"gt={'yes' if gt is not None else 'no'})")
        if len(queries) < BATCH:  # tile queries up to the batch size
            reps = -(-BATCH // len(queries))
            queries = np.tile(queries, (reps, 1))[:BATCH]
            if gt is not None:
                gt = np.tile(gt, (reps, 1))[:BATCH]
        return base, queries.astype(np.float32), gt
    if os.environ.get("COMET_SIFTGEN", "1") != "0":
        # DEFAULT corpus (VERDICT r3 #3): SIFT-descriptor synthetic data
        # (real Lowe-pipeline descriptors over synthetic imagery,
        # comet_tpu/io/siftgen.py) — marginal statistics and PQ codebook
        # distortion match real texmex data by construction, so PQ/IVFPQ
        # recall rows are apples-to-apples with the reference's SIFT1M
        # figures. COMET_SIFTGEN=0 selects the older Gaussian-mixture
        # corpus; neighbor structure is modeled (re-observation ladders),
        # not measured against SIFT1M ground truth.
        from comet_tpu.io import siftgen

        log(f"dataset: siftgen synthetic descriptors ({N} x {DIM})")
        base, queries = siftgen.generate_with_queries(N, BATCH, seed=0)
        return base, queries, None
    corpus, queries = gen_data()
    return corpus, queries, None


def time_search(idx, queries, k, rounds=ROUNDS, **kw):
    """Sustained throughput via the pipelined search_stream API (device
    compute of batch i+1 overlaps batch i's result download), which is how
    a bulk/production consumer drives the index. Falls back to sequential
    search_batch for indexes without a stream path."""
    ids, _ = idx.search_batch(queries, k=k, **kw)  # warmup/compile
    if hasattr(idx, "search_stream"):
        t0 = time.perf_counter()
        outs = list(idx.search_stream([queries] * rounds, k=k, **kw))
        dt = time.perf_counter() - t0
        ids = outs[-1][0]
    else:
        t0 = time.perf_counter()
        for _ in range(rounds):
            ids, _ = idx.search_batch(queries, k=k, **kw)
        dt = time.perf_counter() - t0
    qps = rounds * len(queries) / dt
    return qps, ids


def log_mem(tag, idx, results=None):
    """Exact per-structure memory (stats()['memory']) -> the sweep log;
    the 'equal memory' clause of BASELINE.json is checked against these
    rows (reference numbers: docs/INDEX.md:1977-1990, 3984-3991)."""
    m = idx.stats().get("memory")
    if not m:
        return
    top_h = sorted(m["host"].items(), key=lambda kv: -kv[1])[:3]
    top_d = sorted(m["device"].items(), key=lambda kv: -kv[1])[:3]
    log(f"{tag} memory: host {m['host_total'] / 1e6:,.1f} MB "
        f"{[(k, round(v / 1e6, 1)) for k, v in top_h]}, "
        f"device {m['device_total'] / 1e6:,.1f} MB "
        f"{[(k, round(v / 1e6, 1)) for k, v in top_d]}")
    if results is not None:
        results[f"{tag}_mem_host_mb"] = (m["host_total"] / 1e6, None)
        results[f"{tag}_mem_device_mb"] = (m["device_total"] / 1e6, None)


def recall(found_ids, true_ids):
    hits = sum(
        len(set(f.tolist()) & set(t.tolist())) for f, t in zip(found_ids, true_ids)
    )
    return hits / true_ids.size


def bench_flat(corpus, queries, storage="float32", samples=1):
    from comet_tpu.indexes.flat import FlatIndex
    from comet_tpu.types import DistanceKind

    idx = FlatIndex(DIM, DistanceKind.L2, storage=storage)
    t0 = time.perf_counter()
    idx.add_batch(corpus, ids=IDS)
    log(f"flat[{storage}] add_batch(1M): {time.perf_counter() - t0:.2f}s")
    runs = []
    first = True
    for _ in range(samples):
        qps, ids = time_search(idx, queries, K)
        if first:
            log_mem(f"flat[{storage}]", idx)
            first = False
        runs.append(qps)
    runs.sort()
    qps = runs[len(runs) // 2]
    if samples > 1:
        log(
            f"flat[{storage}] exact k={K}: median {qps:.1f} QPS over "
            f"{samples} samples, band [{runs[0]:.0f}, {runs[-1]:.0f}]"
        )
    else:
        log(f"flat[{storage}] exact k={K}: {qps:.1f} QPS ({1e3 / qps:.3f} ms/query)")
    return qps, ids


def bench_all(corpus, queries, truth_ids, truth100=None):
    from comet_tpu.indexes.bm25 import BM25SearchIndex
    from comet_tpu.indexes.hnsw import HNSWConfig, HNSWIndex
    from comet_tpu.indexes.ivf import IVFIndex
    from comet_tpu.indexes.ivfpq import IVFPQIndex
    from comet_tpu.indexes.metadata import RoaringMetadataIndex, eq, gte
    from comet_tpu.indexes.pq import PQIndex
    from comet_tpu.core.node import new_metadata_node_with_id
    from comet_tpu.types import DistanceKind

    truth10 = truth_ids[:, :10]
    results = {}

    def rec100(found):
        """recall@100 against ground truth when available (the reference's
        published operating points are all recall@100 on SIFT1M)."""
        if truth100 is None:
            return None
        return recall(found[:, :100], truth100)

    def report(name, qps, found):
        r10 = recall(found[:, :10], truth10)
        r100 = rec100(found)
        extra = f", recall@100={r100:.3f}" if r100 is not None else ""
        log(f"{name}: {qps:.1f} QPS, recall@10={r10:.3f}{extra}")
        results[name] = (qps, r10, r100)

    # bf16 flat
    qps, ids = bench_flat(corpus, queries, storage="bfloat16")
    results["flat_bf16"] = (qps, recall(ids[:, :10], truth10), rec100(ids))

    # int8 flat (abs-max quantized storage, VERDICT r3 #7) + exact rerank
    from comet_tpu.indexes.flat import FlatIndex as _FI
    from comet_tpu.types import DistanceKind as _DK

    for rr in (False, True):
        idx = _FI(DIM, _DK.L2, storage="int8", rerank=rr)
        idx.add_batch(corpus, ids=IDS)
        qps, ids = time_search(idx, queries, K)
        report(f"flat_int8{'_rerank' if rr else ''}", qps, ids)
        del idx

    # IVF nlist=1024 (baseline: train 38.5s, add 82s; reference op points
    # nprobe 5/10/20 -> 78.5/89.2/94.7% recall@100, docs/INDEX.md:2836-2849)
    idx = IVFIndex(DIM, 1024, DistanceKind.L2)
    t0 = time.perf_counter()
    idx.train(corpus[:100_000])
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add_batch(corpus, ids=IDS)
    t_add = time.perf_counter() - t0
    log(f"ivf train(100k): {t_train:.2f}s  add(1M): {t_add:.2f}s")
    for nprobe in (1, 5, 10, 20, 32):
        qps, ids = time_search(idx, queries, K, nprobes=nprobe)
        report(f"ivf_nprobe{nprobe}", qps, ids)
    log_mem("ivf", idx, results)
    del idx

    # PQ m=16 nbits=8 (baseline: train 3.2s, add 24.5s, 122 QPS / 91.3%@100)
    idx = PQIndex(DIM, DistanceKind.L2, m=16, nbits=8)
    t0 = time.perf_counter()
    idx.train(corpus[:100_000])
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add_batch(corpus, ids=IDS)
    t_add = time.perf_counter() - t0
    log(f"pq train(100k): {t_train:.2f}s  add(1M): {t_add:.2f}s")
    qps, ids = time_search(idx, queries, K)
    report("pq_m16", qps, ids)
    log_mem("pq", idx, results)
    del idx

    # IVFPQ nlist=1024 m=16 (baseline: 312 QPS / 89.7%@100 at nprobe=10);
    # store_originals enables with_nrefine — the exact re-rank the
    # reference documents but never implemented (README.md:1779)
    idx = IVFPQIndex(
        DIM, DistanceKind.L2, nlist=1024, m=16, nbits=8, store_originals=True
    )
    t0 = time.perf_counter()
    idx.train(corpus[:100_000])
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add_batch(corpus, ids=IDS)
    t_add = time.perf_counter() - t0
    log(f"ivfpq train(100k): {t_train:.2f}s  add(1M): {t_add:.2f}s")
    for nprobe in (8, 10, 32):
        qps, ids = time_search(idx, queries, K, nprobes=nprobe)
        report(f"ivfpq_nprobe{nprobe}", qps, ids)
    # ADC recall is quantizer-bound on descriptor data; nrefine recovers
    # exactness within the ADC shortlist at PQ memory traffic
    qps, ids = time_search(idx, queries, K, nprobes=10, nrefine=256)
    report("ivfpq_nprobe10_nrefine256", qps, ids)
    log_mem("ivfpq", idx, results)
    del idx

    # OPQ + device-fused nrefine: the recall@10 x QPS operating point
    # (VERDICT r4 #2; target >=0.95 recall@10 at >=10k QPS). OPQ is an
    # extension like nrefine: the reference has neither.
    idx = IVFPQIndex(
        DIM, DistanceKind.L2, nlist=1024, m=16, nbits=8,
        store_originals=True, opq=True,
    )
    t0 = time.perf_counter()
    idx.train(corpus[:100_000])
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add_batch(corpus, ids=IDS)
    t_add = time.perf_counter() - t0
    log(f"ivfpq-opq train(100k): {t_train:.2f}s  add(1M): {t_add:.2f}s")
    qps, ids = time_search(idx, queries, K, nprobes=10)
    report("ivfpq_opq_nprobe10", qps, ids)
    for nprobe, nref in ((16, 256), (32, 256), (32, 512), (64, 512)):
        qps, ids = time_search(idx, queries, 10, nprobes=nprobe, nrefine=nref)
        r10 = recall(ids[:, :10], truth10)
        log(f"ivfpq_opq nprobe={nprobe} nrefine={nref} k=10: "
            f"{qps:.1f} QPS, recall@10={r10:.3f}")
        results[f"ivfpq_opq_np{nprobe}_nr{nref}"] = (qps, r10, None)
    del idx

    # HNSW M=16 (baseline: build 5000s=200vec/s on 1M; ef50 2380QPS/93.4%@100).
    # Benchmarked at 200k (sweep budget); COMET_BENCH_HNSW_1M=1 adds a 1M
    # build+search point. Iteration counts are the beam's real work knob
    # (HNSWConfig.search_iters).
    n_hnsw = 200_000
    idx = HNSWIndex(DIM, DistanceKind.L2, HNSWConfig(m=16, ef_construction=128, ef_search=128))
    t0 = time.perf_counter()
    idx.add_batch(corpus[:n_hnsw], ids=IDS[:n_hnsw])
    t_build = time.perf_counter() - t0
    log(f"hnsw build({n_hnsw}): {t_build:.1f}s ({n_hnsw / t_build:.0f} vec/s)")
    from comet_tpu.indexes.flat import FlatIndex as _F
    oracle = _F(DIM, DistanceKind.L2)
    oracle.add_batch(corpus[:n_hnsw], ids=IDS[:n_hnsw])
    tr_ids, _ = oracle.search_batch(queries, k=100)
    # seeded beam (the default at this scale): the beam starts from an
    # IVF cluster-probe scan, so few expansion iterations are needed
    for iters in (6, 8, 12, 16, 0):
        idx.config.search_iters = iters
        qps, ids = time_search(idx, queries, 100, ef_search=256)
        r10 = recall(ids[:, :10], tr_ids[:, :10])
        r100 = recall(ids[:, :100], tr_ids)
        tag = f"seeded,iters={iters or 'auto'}"
        log(f"hnsw {tag}: {qps:.1f} QPS, recall@10={r10:.3f}, recall@100={r100:.3f}")
        results[f"hnsw_{tag}"] = (qps, r10, r100)
    # classic entry-point beam for comparison
    idx.config.seed_search = False
    for ef, iters in ((256, 32), (256, 48)):
        idx.config.search_iters = iters
        qps, ids = time_search(idx, queries, 100, ef_search=ef)
        r10 = recall(ids[:, :10], tr_ids[:, :10])
        r100 = recall(ids[:, :100], tr_ids)
        tag = f"classic,ef={ef},iters={iters or 'auto'}"
        log(f"hnsw {tag}: {qps:.1f} QPS, recall@10={r10:.3f}, recall@100={r100:.3f}")
        results[f"hnsw_{tag}"] = (qps, r10, r100)
    idx.config.seed_search = True
    idx.config.search_iters = 0
    log_mem("hnsw200k", idx, results)
    del idx, oracle

    if os.environ.get("COMET_BENCH_HNSW_1M"):
        idx = HNSWIndex(DIM, DistanceKind.L2, HNSWConfig(m=16, ef_construction=128))
        t0 = time.perf_counter()
        idx.add_batch(corpus, ids=IDS)
        t_build = time.perf_counter() - t0
        log(f"hnsw build(1M): {t_build:.1f}s ({N / t_build:.0f} vec/s)")
        for iters in (24, 32, 48):
            idx.config.search_iters = iters
            qps, ids = time_search(idx, queries, 100, ef_search=256)
            r100 = recall(ids[:, :100], truth_ids[:, :100])
            log(f"hnsw-1M ef=256,iters={iters}: {qps:.1f} QPS, recall@100={r100:.3f}")
            results[f"hnsw1m_iters{iters}"] = (qps, None, r100)
        del idx

    # BM25 at the reference's scale: 1M docs x 60 tokens (baseline: 2,000
    # docs/s ingest; 1/2/10-term = 3/8/12 ms on 1M Wikipedia docs,
    # docs/INDEX.md:6319-6350). Letter-only zipf vocabulary (UAX#29 keeps
    # each word whole); wordlike_only skips whitespace segments — the
    # production configuration (parity mode indexes every segment, which
    # makes EVERY query also scan the 1M-doc " " posting like the
    # reference's code would).
    rng = np.random.default_rng(1)
    n_vocab = 50_000
    vocab = np.array(
        ["".join(chr(97 + (i // 26 ** j) % 26) for j in range(4)) + "x"
         for i in range(n_vocab)]
    )
    n_docs = 1_000_000
    bm = BM25SearchIndex(wordlike_only=True)
    zipf = rng.zipf(1.3, size=(n_docs, 60)) % n_vocab
    texts = [" ".join(vocab[t]) for t in zipf]
    t0 = time.perf_counter()
    bm.add_batch(range(1, n_docs + 1), texts)
    t_index = time.perf_counter() - t0
    log(f"bm25 index {n_docs} docs x60 tokens: {t_index:.1f}s "
        f"({n_docs / t_index:.0f} docs/s)")
    results["bm25_ingest_docs_per_s"] = (n_docs / t_index, None)
    # mid-frequency query terms (zipf ranks 100..5000 — the shape of real
    # search terms; rank-1 terms appear in ~every doc and any engine's
    # latency is then just posting-scan bandwidth)
    qterms = [vocab[100 + (i * 37) % 4900] for i in range(4000)]
    # warmup: first query pays the one-time native postings-CSR build
    bm.new_search().with_query(qterms[0]).with_k(10).execute()
    for nt, nq in ((1, 300), (2, 300), (10, 100)):
        t0 = time.perf_counter()
        for i in range(nq):
            q = " ".join(qterms[(i * nt + j) % len(qterms)] for j in range(nt))
            bm.new_search().with_query(q).with_k(10).execute()
        dt = time.perf_counter() - t0
        log(f"bm25 {nt}-term query: {1e3 * dt / nq:.2f} ms/query ({nq / dt:.0f} QPS)")
        results[f"bm25_{nt}term_ms"] = (1e3 * dt / nq, None)
    qs = [qterms[i] + " " + qterms[(i * 7) % len(qterms)] for i in range(256)]
    bm.search_batch(qs, k=10)
    t0 = time.perf_counter()
    bm.search_batch(qs, k=10)
    dt = time.perf_counter() - t0
    log(f"bm25 2-term batch x256: {1e3 * dt / 256:.3f} ms/query ({256 / dt:.0f} QPS)")
    results["bm25_2term_batch_ms"] = (1e3 * dt / 256, None)
    del bm, texts, zipf

    # Hybrid end-to-end (baseline claim: P95 15 ms / P99 35 ms @ 5M docs,
    # docs/INDEX.md:8380-8386) — vector + text + metadata filter + RRF
    from comet_tpu.hybrid import new_hybrid_search_index
    from comet_tpu.indexes.flat import FlatIndex as _FF
    from comet_tpu.types import FusionKind

    n_h = 100_000
    hybrid = new_hybrid_search_index(
        _FF(DIM, DistanceKind.L2), BM25SearchIndex(wordlike_only=True),
        RoaringMetadataIndex(),
    )
    hv = hybrid.vector_index()
    hv.add_batch(corpus[:n_h], ids=IDS[:n_h])
    rng_h = np.random.default_rng(3)
    words = [f"w{i}" for i in range(5000)]
    zipf_h = rng_h.zipf(1.3, size=(n_h, 12)) % len(words)
    for i in range(n_h):
        hybrid._text.add(int(IDS[i]), " ".join(words[t] for t in zipf_h[i]))
    meta_nodes = [
        new_metadata_node_with_id(
            int(IDS[i]), {"cat": ["a", "b", "c", "d"][i % 4], "num": int(i % 1000)}
        )
        for i in range(n_h)
    ]
    hybrid._metadata.add_batch(meta_nodes)
    # doc_info bookkeeping (bulk path: sub-indexes were filled directly)
    from comet_tpu.hybrid import _DocInfo

    hybrid._doc_info = {int(IDS[i]): _DocInfo(True, True, True) for i in range(n_h)}

    lat = []
    nq = 100
    # warmup
    hybrid.new_search().with_vector(queries[0]).with_text("w1 w17").with_metadata(
        eq("cat", "a")
    ).with_fusion_kind(FusionKind.RECIPROCAL_RANK).with_k(10).execute()
    for i in range(nq):
        t0 = time.perf_counter()
        hybrid.new_search().with_vector(queries[i]).with_text(
            f"w{i % 50} w{(i * 13) % 500}"
        ).with_metadata(eq("cat", ["a", "b", "c", "d"][i % 4])).with_fusion_kind(
            FusionKind.RECIPROCAL_RANK
        ).with_k(10).execute()
        lat.append(time.perf_counter() - t0)
    lat = np.sort(np.array(lat)) * 1e3
    log(
        f"hybrid (vec+text+filter+RRF, {n_h} docs): "
        f"P50 {lat[int(nq * 0.5)]:.1f} ms, P95 {lat[int(nq * 0.95)]:.1f} ms, "
        f"{1000 * nq / lat.sum():.0f} QPS sequential"
    )
    results["hybrid_p95_ms"] = (float(lat[int(nq * 0.95)]), None)
    # hybrid batch: one fused dispatch chain for 256 queries (amortizes the
    # device round-trip the sequential loop above pays per query)
    qs_v = queries[:256]
    texts_b = [f"w{i % 50} w{(i * 13) % 500}" for i in range(256)]
    fkw = dict(
        k=10, metadata_filters=[eq("cat", "a")],
        fusion_kind=FusionKind.RECIPROCAL_RANK,
    )
    hybrid.search_batch(qs_v, texts_b, **fkw)  # warmup/compile
    t0 = time.perf_counter()
    hybrid.search_batch(qs_v, texts_b, **fkw)
    dt = time.perf_counter() - t0
    log(f"hybrid batch x256: {1e3 * dt / 256:.2f} ms/query ({256 / dt:.0f} QPS)")
    results["hybrid_batch_ms"] = (1e3 * dt / 256, None)
    del hybrid

    # Metadata at the reference's scale: 10M docs x 4 fields (baseline:
    # add 540k docs/s, 1-filter 45us, 4-filter 180us, 8-filter 420us —
    # docs/INDEX.md:7242-7276)
    from comet_tpu.indexes.metadata import between, in_filter, lt

    mi = RoaringMetadataIndex()
    cats = ["a", "b", "c", "d", "e"]
    n_meta = 10_000_000
    rng_m = np.random.default_rng(7)
    prices = rng_m.integers(0, 10_000, size=n_meta)
    stock = rng_m.integers(0, 1_000, size=n_meta)
    brand_col = np.array([f"brand{i}" for i in range(100)])[
        rng_m.integers(0, 100, n_meta)
    ]
    meta_ids = np.arange(1, n_meta + 1, dtype=np.uint64)
    cat_col = np.array(cats)[np.arange(n_meta) % 5]
    t0 = time.perf_counter()
    mi.add_columns(
        meta_ids,
        {"cat": cat_col, "brand": brand_col, "price": prices, "stock": stock},
    )
    t_index = time.perf_counter() - t0
    log(f"metadata add_columns {n_meta}: {t_index:.2f}s ({n_meta / t_index:.0f} docs/s)")
    results["metadata_add_docs_per_s"] = (n_meta / t_index, None)
    # node-based batch path for comparison at 1M (per-doc Python routing)
    mi_nodes = RoaringMetadataIndex()
    batch = [
        new_metadata_node_with_id(i + 1, {"cat": cats[i % 5], "price": int(prices[i])})
        for i in range(1_000_000)
    ]
    t0 = time.perf_counter()
    mi_nodes.add_batch(batch)
    t_nodes = time.perf_counter() - t0
    log(f"metadata add_batch(nodes) 1M: {t_nodes:.1f}s ({1_000_000 / t_nodes:.0f} docs/s)")
    del mi_nodes, batch

    def meta_lat(name, mk, nq=300):
        mi._eval(mk(0), [])  # warm BSI caches
        t0 = time.perf_counter()
        for i in range(nq):
            mi._eval(mk(i), [])  # raw eval (filter_bitset memo bypassed)
        dt = time.perf_counter() - t0
        log(f"metadata {name}: {1e6 * dt / nq:.0f} us/query ({nq / dt:.0f} QPS)")
        results[f"metadata_{name}"] = (nq / dt, None)

    meta_lat("1filter_eq", lambda i: [eq("cat", cats[i % 5])])
    meta_lat("2filter_and", lambda i: [eq("cat", cats[i % 5]), gte("price", 5000)])
    meta_lat(
        "4filter_and",
        lambda i: [eq("cat", cats[i % 5]), eq("brand", "brand7"),
                   gte("price", 2000), lt("stock", 500)],
    )
    meta_lat(
        "8filter_and",
        lambda i: [eq("cat", cats[i % 5]), eq("brand", "brand7"),
                   gte("price", 2000), lt("price", 8000), gte("stock", 100),
                   lt("stock", 900), in_filter("cat", "a", "b"),
                   between("price", 2500, 7500)],
        nq=150,
    )
    # memoized serving path (repeat predicate traffic)
    t0 = time.perf_counter()
    nq = 500
    for i in range(nq):
        mi.filter_bitset([eq("cat", cats[i % 5]), gte("price", 5000)])
    dt = time.perf_counter() - t0
    log(f"metadata 2-filter memoized: {1e6 * dt / nq:.0f} us/query")
    results["metadata_2filter_memoized_us"] = (1e6 * dt / nq, None)

    return results


def bench_scale(n=4_000_000):
    """4M-row scale benchmark: IVF's list walk should beat flat on QPS
    because its compute tracks nprobe (the reference scans only probed
    lists, ivf_index_search.go:244-301; at 4M the reference has no
    published numbers at all)."""
    from comet_tpu.indexes.flat import FlatIndex
    from comet_tpu.indexes.ivf import IVFIndex
    from comet_tpu.types import DistanceKind

    log(f"--- scale bench: n={n} ---")
    corpus, queries = gen_data(n=n)
    ids = np.arange(1, n + 1, dtype=np.uint32)

    flat = FlatIndex(DIM, DistanceKind.L2)
    t0 = time.perf_counter()
    flat.add_batch(corpus, ids=ids)
    log(f"flat add({n}): {time.perf_counter() - t0:.1f}s")
    flat_qps, gt_ids = time_search(flat, queries, K)
    log(f"flat_4m: {flat_qps:.1f} QPS (exact)")
    del flat

    nlist = 2048  # ~sqrt(4M)
    idx = IVFIndex(DIM, nlist, DistanceKind.L2)
    t0 = time.perf_counter()
    idx.train(corpus[:200_000])
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add_batch(corpus, ids=ids)
    t_add = time.perf_counter() - t0
    log(f"ivf4m train(200k,nlist={nlist}): {t_train:.1f}s  add({n}): {t_add:.1f}s")
    results = {"flat_4m": (flat_qps, 1.0, 1.0)}
    for nprobe in (16, 32, 45, 64):
        qps, found = time_search(idx, queries, K, nprobes=nprobe)
        r100 = recall(found[:, :100], gt_ids[:, :100])
        log(
            f"ivf_4m_nprobe{nprobe}: {qps:.1f} QPS, recall@100={r100:.3f}"
            f"  ({qps / flat_qps:.1f}x flat)"
        )
        results[f"ivf_4m_nprobe{nprobe}"] = (qps, None, r100)
    return results


def main():
    global IDS
    from comet_tpu.utils.device import NoGPUError, card_power, require_gpu

    try:
        device = require_gpu()
    except NoGPUError as e:
        log(f"bench: {e}")
        sys.exit(1)
    log(f"device: {device} card: {card_power()}")
    run_all = "--all" in sys.argv
    if "--scale" in sys.argv:
        bench_scale()
        return
    corpus, queries, gt = load_data()
    IDS = np.arange(1, N + 1, dtype=np.uint32)
    # Headline = MEDIAN of 5 independent samples (each `ROUNDS` full query
    # batches) with the min-max band logged.
    qps, ids = bench_flat(corpus, queries, samples=5)

    if gt is not None:
        # sanity: flat exact scan must reproduce the dataset's ground truth
        gt_ids = (gt[:, :100] + 1).astype(np.uint32)  # ivecs ids are 0-based
        r = recall(ids[:, :100], gt_ids)
        log(f"flat recall@100 vs dataset ground truth: {r:.4f}")

    if run_all:
        truth_ids = ids  # flat f32 results ARE the exact ground truth
        truth100 = (
            (gt[:, :100] + 1).astype(np.uint32) if gt is not None
            else ids[:, :100]
        )
        bench_all(corpus, queries, truth_ids, truth100)

    print(json.dumps({
        "metric": "flat_exact_scan_qps_sift1m_k100",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / BASELINE_FLAT_QPS, 2),
        "device": device,
    }))


if __name__ == "__main__":
    main()
