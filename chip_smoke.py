"""Smoke test of comet_tpu's main path on one NVIDIA GPU.

    python chip_smoke.py                 # one GPU: six phases at SIFT1M shape
    python chip_smoke.py --four-cards    # four GPUs: the comet_tpu.parallel path

Each phase drives the public library API at 1M x 128-d, L2 (the reference's
own benchmark scale), on data generated from --seed by the benchmark's
default generator (io/siftgen: SIFT descriptors of synthetic images; the
four-card run uses bench.gen_data, a Gaussian mixture, which generates 4M
rows in seconds), and compares the results with the numpy oracle of
tests/oracle.py computed in float64 on the host:

  1. flat        FlatIndex add_batch + search_batch, 2048 queries, k=100
  2. ivf         IVFIndex nlist=1024, nprobe=20
  3. pq, ivfpq   PQIndex m=16; IVFPQIndex nlist=1024 m=16 nprobe=10, with
                 and without nrefine=256 (against an ADC oracle built from
                 each index's own codebooks)
  4. hnsw        HNSWIndex M=16 bulk build + search at ef=256, k=100:
                 recall@100 against the exact oracle, floor 0.95
  5. hybrid      flat + BM25 + metadata, RRF, an eq filter, 100k docs:
                 against the same coordinator with an oracle vector side
  6. store       persistent hybrid store at 10k docs: add, flush, close,
                 reopen, search

Exact results must equal the oracle's, except where two neighbours' oracle
squared distances differ by less than the float32 rounding bound
16 * 2^-23 * (max |q|^2 + max |x|^2), which the script prints beside the
worst difference it saw. The bound is far below what TF32 products (10-bit
mantissa) would cause, so it also checks that exact paths keep float32.

Prints the card's name and power limit (nvidia-smi), the device, compile and
warm times per phase, and as its last line one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no such line, when JAX's default device is not a
GPU or when any phase fails. QPS figures are for information only.

The compile cache is JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
EPS32 = 2.0 ** -23
BOUND_ULPS = 16
HNSW_RECALL_FLOOR = 0.95


@dataclasses.dataclass
class Config:
    """Sizes of one run. The defaults are the full smoke; tests shrink them."""

    rows: int = 1_000_000
    queries: int = 2048
    check: int = 128          # queries compared with the float64 oracle
    k: int = 100
    nlist: int = 1024
    ivf_nprobe: int = 20
    pq_m: int = 16
    ivfpq_nprobe: int = 10
    nrefine: int = 256
    train_rows: int = 100_000
    hnsw_m: int = 16
    hnsw_ef_construction: int = 128
    hnsw_ef: int = 256
    hybrid_rows: int = 100_000
    hybrid_k: int = 10
    store_rows: int = 10_000
    store_k: int = 10
    store_check: int = 64
    seed: int = 0
    data: str = "siftgen"     # or "gen_data"


class PhaseError(AssertionError):
    """A phase's results disagree with the oracle."""


def log(msg: str) -> None:
    print(msg, flush=True)


# -- data and oracle ---------------------------------------------------------


def make_data(cfg: Config):
    """(corpus [rows, 128], queries [queries, 128]) from one of the
    benchmark's generators: io/siftgen or bench.gen_data."""
    if cfg.data == "siftgen":
        from comet_tpu.io import siftgen

        return siftgen.generate_with_queries(cfg.rows, cfg.queries,
                                             seed=cfg.seed)
    from bench import gen_data

    corpus, queries = gen_data(n=cfg.rows, seed=cfg.seed)
    return corpus, queries[: cfg.queries]


def _test_oracle():
    """tests/oracle.py, loaded by path (an installed package named `tests`
    may shadow the repo's directory)."""
    import importlib.util

    name = "comet_tests_oracle"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "tests", "oracle.py")
        )
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


class Oracle:
    """Float64 squared distances of the check queries to the corpus."""

    def __init__(self, corpus: np.ndarray, queries: np.ndarray):
        distances_np = _test_oracle().distances_np

        self.corpus = corpus
        self.q = queries.astype(np.float64)
        self.sq = distances_np(self.q, corpus, "l2_squared", dtype=np.float64)
        qn = (self.q * self.q).sum(axis=1)
        xn = np.einsum("nd,nd->n", corpus, corpus, dtype=np.float64)
        self.bound = BOUND_ULPS * EPS32 * (qn.max() + xn.max())


def _row_topk(d: np.ndarray, k: int) -> np.ndarray:
    """Row indices of the k smallest finite entries, (value, index)
    ascending: every entry tied with the k-th joins the candidates, so
    ties break by index as on the device."""
    k = min(k, len(d))
    kth = np.partition(d, k - 1)[k - 1]
    cand = np.flatnonzero(d <= kth)
    order = cand[np.lexsort((cand, d[cand]))][:k]
    return order[np.isfinite(d[order])]


def check_exact(name: str, ids, scores, want_sq: np.ndarray, k: int,
                bound: float) -> dict:
    """Per query, position by position: the oracle's squared distance of
    the returned row may differ from that of the oracle's row at the same
    rank by at most `bound` (a swap of near-equal neighbours), the returned
    score must match its row's oracle distance within `bound`, rows must be
    distinct, and no oracle row may be missing beyond a near-tie. Ids are
    rows + 1. Returns {"worst", "bound", "checked"}."""
    worst = 0.0
    for qi in range(want_sq.shape[0]):
        w = want_sq[qi]
        want_rows = _row_topk(w, k)
        got = np.asarray(ids[qi][: len(want_rows)], dtype=np.int64) - 1
        if len(got) != len(want_rows) or np.any(got < 0) or np.any(
            got >= len(w)
        ):
            raise PhaseError(f"{name}: query {qi} returned rows {got[:8]}... "
                             f"for {len(want_rows)} oracle rows")
        if len(np.unique(got)) != len(got):
            raise PhaseError(f"{name}: query {qi} returned a row twice")
        diff = np.abs(w[got] - w[want_rows])
        sc = np.asarray(scores[qi][: len(got)], dtype=np.float64)
        sdiff = np.abs(sc * sc - w[got])
        worst = max(worst, float(diff.max(initial=0.0)),
                    float(sdiff.max(initial=0.0)))
        if not np.all(diff <= bound) or not np.all(sdiff <= bound):
            j = int(np.argmax(np.maximum(diff, sdiff)))
            raise PhaseError(
                f"{name}: query {qi} rank {j}: row {got[j]} (d^2 "
                f"{w[got[j]]:.6g}, score {sc[j]:.6g}) vs oracle row "
                f"{want_rows[j]} (d^2 {w[want_rows[j]]:.6g}); bound {bound:.4g}"
            )
    log(f"  {name}: {want_sq.shape[0]} queries match the float64 oracle; "
        f"bound {bound:.4g} (squared distance), worst {worst:.4g}")
    return {"worst": worst, "bound": bound, "checked": want_sq.shape[0]}


def probe_masked(centroids, assign, q64, nprobe: int, bound: float):
    """For each check query: the rows of the nprobe lists nearest in float64
    (a [N] bool mask), or None when the nprobe-th and next centroid are
    within `bound` of each other but not equal (the probe set itself is a
    near-tie; an exact tie goes to the lower list id on both sides)."""
    c64 = centroids.astype(np.float64)
    cd = ((q64[:, None, :] - c64[None, :, :]) ** 2).sum(axis=2)
    out = []
    for qi in range(len(q64)):
        order = np.argsort(cd[qi], kind="stable")
        if nprobe < len(order) and (
            0 < cd[qi, order[nprobe]] - cd[qi, order[nprobe - 1]] <= bound
        ):
            out.append(None)
            continue
        out.append(np.isin(assign, order[:nprobe]))
    return out


def ivf_oracle(idx, ctx, nprobe: int):
    """Oracle squared distances restricted to each check query's nprobe
    nearest lists of an IVF index (inf elsewhere), for the queries whose
    probe set is not a near-tie; returns (want [kept, N], kept rows)."""
    masks = probe_masked(idx._centroids, idx._assign[: ctx.cfg.rows],
                         ctx.oracle.q, nprobe, ctx.oracle.bound)
    keep = [i for i, m in enumerate(masks) if m is not None]
    want = np.stack([np.where(masks[i], ctx.oracle.sq[i], np.inf)
                     for i in keep])
    return want, keep


# -- timing ------------------------------------------------------------------


def timed_search(name: str, run, nq: int, card: str) -> tuple:
    """First call (compile + run) and a warm call; prints both."""
    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run()
    warm = time.perf_counter() - t0
    log(f"  {name}: first call (compile + run) {first:.3f} s, warm "
        f"{warm:.4f} s = {nq / warm:.1f} QPS [{card}]")
    return out, {"first_s": first, "warm_s": warm, "qps": nq / warm}


# -- phases ------------------------------------------------------------------


def phase_flat(ctx) -> dict:
    from comet_tpu import DistanceKind, FlatIndex

    cfg = ctx.cfg
    idx = FlatIndex(ctx.corpus.shape[1], DistanceKind.L2)
    t0 = time.perf_counter()
    idx.add_batch(ctx.corpus, ids=ctx.ids)
    log(f"  flat add_batch({cfg.rows}): {time.perf_counter() - t0:.2f} s")
    (ids, scores), t = timed_search(
        "flat search_batch",
        lambda: idx.search_batch(ctx.queries, k=cfg.k), len(ctx.queries),
        ctx.card,
    )
    c = ctx.check
    res = check_exact("flat", ids[:c], scores[:c], ctx.oracle.sq, cfg.k,
                      ctx.oracle.bound)
    return {**res, **t}


def phase_ivf(ctx) -> dict:
    from comet_tpu import DistanceKind, IVFIndex

    cfg = ctx.cfg
    idx = IVFIndex(ctx.corpus.shape[1], cfg.nlist, DistanceKind.L2)
    t0 = time.perf_counter()
    idx.train(ctx.corpus[: cfg.train_rows])
    idx.add_batch(ctx.corpus, ids=ctx.ids)
    log(f"  ivf train({cfg.train_rows}) + add_batch({cfg.rows}): "
        f"{time.perf_counter() - t0:.2f} s")
    (ids, scores), t = timed_search(
        f"ivf search_batch nprobe={cfg.ivf_nprobe}",
        lambda: idx.search_batch(ctx.queries, k=cfg.k, nprobes=cfg.ivf_nprobe),
        len(ctx.queries), ctx.card,
    )
    want, keep = ivf_oracle(idx, ctx, cfg.ivf_nprobe)
    res = check_exact("ivf", ids[keep], scores[keep], want, cfg.k,
                      ctx.oracle.bound)
    log(f"  ivf: {ctx.check - len(keep)} queries skipped (probe-set near-tie)")
    return {**res, **t}


def _adc_sq(q64, codes, codebooks) -> np.ndarray:
    """Float64 ADC squared distances [len(q64), len(codes)]: the sum over
    subspaces of |q_m - codebook[m, code_m]|^2."""
    m, _, dsub = codebooks.shape
    cb = codebooks.astype(np.float64)
    out = np.zeros((len(q64), len(codes)))
    for j in range(m):
        qm = q64[:, j * dsub:(j + 1) * dsub]
        lut = ((qm[:, None, :] - cb[j][None, :, :]) ** 2).sum(axis=2)
        out += lut[:, codes[:, j]]
    return out


def phase_pq(ctx) -> dict:
    from comet_tpu import DistanceKind, PQIndex

    cfg = ctx.cfg
    idx = PQIndex(ctx.corpus.shape[1], DistanceKind.L2, m=cfg.pq_m, nbits=8)
    t0 = time.perf_counter()
    idx.train(ctx.corpus[: cfg.train_rows])
    idx.add_batch(ctx.corpus, ids=ctx.ids)
    log(f"  pq train({cfg.train_rows}) + add_batch({cfg.rows}): "
        f"{time.perf_counter() - t0:.2f} s")
    (ids, scores), t = timed_search(
        f"pq search_batch m={cfg.pq_m}",
        lambda: idx.search_batch(ctx.queries, k=cfg.k), len(ctx.queries),
        ctx.card,
    )
    want = _adc_sq(ctx.oracle.q, idx._codes[: cfg.rows], idx._codebooks)
    res = check_exact("pq (ADC oracle)", ids[: ctx.check], scores[: ctx.check],
                      want, cfg.k, ctx.oracle.bound)
    return {**res, **t}


def _ivfpq_oracle(idx, ctx, nprobe: int, nrefine: int):
    """Float64 IVFPQ oracle from the index's own model: residual ADC over
    the nprobe nearest lists; with `nrefine`, the exact distances of the
    ADC shortlist. Returns ([check, N] squared distances, inf outside,
    kept query rows)."""
    cfg = ctx.cfg
    n = cfg.rows
    assign = idx._assign[:n]
    codes = idx._codes[:n]
    cents = idx._centroids.astype(np.float64)
    masks = probe_masked(idx._centroids, assign, ctx.oracle.q, nprobe,
                         ctx.oracle.bound)
    rows_of = {}
    order = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order], np.arange(len(cents) + 1))
    for c in range(len(cents)):
        rows_of[c] = order[bounds[c]:bounds[c + 1]]
    keep, out = [], []
    for qi, mask in enumerate(masks):
        if mask is None:
            continue
        q = ctx.oracle.q[qi]
        lists = np.unique(assign[mask])
        adc = np.full(n, np.inf)
        for c in lists:
            r = rows_of[int(c)]
            adc[r] = _adc_sq((q - cents[c])[None], codes[r], idx._codebooks)[0]
        if nrefine:
            short = _row_topk(adc, nrefine + 1)
            # the shortlist's last place is a near-tie the float32 sums may
            # order either way (exact ties are identical codes in one list:
            # equal on the device too, and both sides order them by row)
            if len(short) > nrefine and (
                0 < adc[short[nrefine]] - adc[short[nrefine - 1]]
                <= ctx.oracle.bound
            ):
                continue
            exact = np.full(n, np.inf)
            exact[short[:nrefine]] = ctx.oracle.sq[qi, short[:nrefine]]
            adc = exact
        keep.append(qi)
        out.append(adc)
    return np.stack(out), keep


def phase_ivfpq(ctx) -> dict:
    from comet_tpu import DistanceKind, IVFPQIndex

    cfg = ctx.cfg
    idx = IVFPQIndex(ctx.corpus.shape[1], DistanceKind.L2, nlist=cfg.nlist,
                     m=cfg.pq_m, nbits=8, store_originals=True)
    t0 = time.perf_counter()
    idx.train(ctx.corpus[: cfg.train_rows])
    idx.add_batch(ctx.corpus, ids=ctx.ids)
    log(f"  ivfpq train({cfg.train_rows}) + add_batch({cfg.rows}): "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}
    for nrefine in (0, cfg.nrefine):
        tag = f"ivfpq nprobe={cfg.ivfpq_nprobe} nrefine={nrefine}"
        kw = {"nprobes": cfg.ivfpq_nprobe}
        if nrefine:
            kw["nrefine"] = nrefine
        (ids, scores), t = timed_search(
            f"{tag} search_batch",
            lambda: idx.search_batch(ctx.queries, k=cfg.k, **kw),
            len(ctx.queries), ctx.card,
        )
        want, keep = _ivfpq_oracle(idx, ctx, cfg.ivfpq_nprobe, nrefine)
        res = check_exact(tag, ids[keep], scores[keep], want, cfg.k,
                          ctx.oracle.bound)
        log(f"  {tag}: {ctx.check - len(keep)} queries skipped (near-tie)")
        out[f"nrefine{nrefine}"] = {**res, **t}
    return out


def phase_hnsw(ctx) -> dict:
    from comet_tpu import DistanceKind, HNSWConfig, HNSWIndex

    cfg = ctx.cfg
    n = cfg.rows
    idx = HNSWIndex(ctx.corpus.shape[1], DistanceKind.L2, HNSWConfig(
        m=cfg.hnsw_m, ef_construction=cfg.hnsw_ef_construction))
    t0 = time.perf_counter()
    idx.add_batch(ctx.corpus, ids=ctx.ids)
    t_build = time.perf_counter() - t0
    log(f"  hnsw bulk build({n}, M={cfg.hnsw_m}, "
        f"efC={cfg.hnsw_ef_construction}): {t_build:.2f} s [{ctx.card}]")
    (ids, scores), t = timed_search(
        f"hnsw search_batch ef={cfg.hnsw_ef}",
        lambda: idx.search_batch(ctx.queries, k=cfg.k, ef_search=cfg.hnsw_ef),
        len(ctx.queries), ctx.card,
    )
    want = ctx.oracle.sq
    hits = 0
    worst = 0.0
    for qi in range(ctx.check):
        truth = _row_topk(want[qi], cfg.k)
        got = np.asarray(ids[qi], dtype=np.int64) - 1
        got = got[(got >= 0) & (got < n)]
        hits += len(np.intersect1d(got, truth))
        sc = np.asarray(scores[qi][: len(got)], dtype=np.float64)
        worst = max(worst, float(np.abs(sc * sc - want[qi, got]).max(initial=0)))
    rec = hits / (ctx.check * cfg.k)
    log(f"  hnsw recall@{cfg.k} = {rec:.4f} over {ctx.check} queries "
        f"(floor {HNSW_RECALL_FLOOR}); worst score error {worst:.4g} "
        f"(bound {ctx.oracle.bound:.4g})")
    if rec < HNSW_RECALL_FLOOR:
        raise PhaseError(f"hnsw: recall@{cfg.k} {rec:.4f} < {HNSW_RECALL_FLOOR}")
    if worst > ctx.oracle.bound:
        raise PhaseError(f"hnsw: a score is off its row's distance by {worst}")
    return {"recall": rec, "build_s": t_build, **t}


def _oracle_flat_class():
    """A FlatIndex whose search answers from the float64 oracle on the host
    (the hybrid phase's reference vector side)."""
    from comet_tpu import FlatIndex
    from comet_tpu.core.filter import DocumentFilter
    from comet_tpu.core.limiter import sanitize_k

    class OracleFlat(FlatIndex):
        def _search_launch(self, queries, builder):
            return ("oracle", np.asarray(queries, np.float64), builder)

        def _search_collect(self, handle):
            _, q, builder = handle
            st = self._store
            n = st.n
            k = sanitize_k(builder._k, n)
            x = st.vectors[:n].astype(np.float64)
            d = ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
                 - 2.0 * q @ x.T)
            ok = st.valid[:n].copy()
            fmask = DocumentFilter(builder._document_ids).slot_mask(st.ids)
            if fmask is not None:
                ok &= fmask[:n]
            d = np.where(ok[None, :], np.maximum(d, 0.0), np.inf)
            ids = np.full((len(q), k), 0xFFFFFFFF, np.uint32)
            sc = np.zeros((len(q), k), np.float32)
            for qi in range(len(q)):
                rows = _row_topk(d[qi], k)
                ids[qi, : len(rows)] = st.ids[rows]
                sc[qi, : len(rows)] = np.sqrt(d[qi, rows])
            return ids, sc

    return OracleFlat


def _texts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed + 3)
    words = np.array([f"w{i}" for i in range(5000)])
    zipf = rng.zipf(1.3, size=(n, 12)) % len(words)
    return [" ".join(row) for row in words[zipf]]


def check_hybrid(name: str, got, want, vec_side, ctx, n: int) -> dict:
    """Fused result lists must equal the oracle coordinator's. A swap of
    near-equal neighbours on the vector side changes RRF ranks, so a query
    whose vector-side ids differ from the oracle's is checked on its vector
    side alone, by check_exact. `vec_side` is (v_got_ids, v_got_scores,
    v_want_ids) for the same queries and filter (cat "a": rows % 4 == 0)."""
    v_got, v_sc, v_want = vec_side
    c = len(got)
    ties = 0
    for qi in range(c):
        g = [(r.id, r.score) for r in got[qi]]
        w = [(r.id, r.score) for r in want[qi]]
        # fused RRF scores are exact; a query without text hits returns its
        # float32 vector distances, whose squares match the oracle's within
        # the squared-distance bound
        gs = np.array([s for _, s in g])
        ws = np.array([s for _, s in w])
        if [i for i, _ in g] == [i for i, _ in w] and np.all(
            np.abs(gs * gs - ws * ws) <= ctx.oracle.bound
        ):
            continue
        if list(v_got[qi]) != list(v_want[qi]):
            ties += 1
            continue
        raise PhaseError(f"{name}: query {qi}: {g[:4]}... vs oracle {w[:4]}...")
    filt = np.where(np.arange(n) % 4 == 0, ctx.oracle.sq[:c, :n], np.inf)
    res = check_exact(f"{name} vector side", v_got, v_sc, filt,
                      ctx.cfg.hybrid_k, ctx.oracle.bound)
    log(f"  {name}: {c - ties} fused result lists equal the oracle "
        f"coordinator's; {ties} differ only by a vector-side near-tie")
    return {**res, "ties": ties}


def phase_hybrid(ctx) -> dict:
    from comet_tpu import (
        BM25SearchIndex, DistanceKind, FlatIndex, FusionKind,
        RoaringMetadataIndex, new_hybrid_search_index,
    )
    from comet_tpu.indexes.metadata import eq

    cfg = ctx.cfg
    n = min(cfg.hybrid_rows, cfg.rows)
    dim = ctx.corpus.shape[1]
    text_idx = BM25SearchIndex(wordlike_only=True)
    meta_idx = RoaringMetadataIndex()
    hybrid = new_hybrid_search_index(
        FlatIndex(dim, DistanceKind.L2), text_idx, meta_idx
    )
    texts = _texts(n, cfg.seed)
    cats = "abcd"
    t0 = time.perf_counter()
    hybrid.add_batch_with_ids(
        (int(ctx.ids[i]), ctx.corpus[i], texts[i], {"cat": cats[i % 4]})
        for i in range(n)
    )
    log(f"  hybrid add_batch_with_ids({n}): {time.perf_counter() - t0:.2f} s")
    ref = new_hybrid_search_index(
        _oracle_flat_class()(dim, DistanceKind.L2), text_idx, meta_idx
    )
    ref.vector_index().add_batch(ctx.corpus[:n], ids=ctx.ids[:n])

    c = ctx.check
    qv = ctx.queries[:c]
    qt = [f"w{i % 50} w{(i * 13) % 500}" for i in range(c)]
    kw = dict(k=cfg.hybrid_k, metadata_filters=[eq("cat", "a")],
              fusion_kind=FusionKind.RECIPROCAL_RANK)
    got, t = timed_search(
        "hybrid search_batch (vector + text + eq filter, RRF)",
        lambda: hybrid.search_batch(qv, qt, **kw), c, ctx.card,
    )
    want = ref.search_batch(qv, qt, **kw)
    cat_a = np.flatnonzero(np.arange(n) % 4 == 0) + 1
    v_got, v_sc = hybrid.vector_index().search_batch(
        qv, k=cfg.hybrid_k, document_ids=cat_a)
    v_want, _ = ref.vector_index().search_batch(
        qv, k=cfg.hybrid_k, document_ids=cat_a)
    res = check_hybrid("hybrid", got, want, (v_got, v_sc, v_want), ctx, n)
    return {**res, **t}


def phase_store(ctx) -> dict:
    from comet_tpu import (
        BM25SearchIndex, DistanceKind, FlatIndex, RoaringMetadataIndex,
        StorageConfig, open_persistent_hybrid_index,
    )

    cfg = ctx.cfg
    n = min(cfg.store_rows, cfg.rows)
    dim = ctx.corpus.shape[1]
    base = tempfile.mkdtemp(prefix="comet_smoke_store_")
    try:
        def config():
            return StorageConfig(
                base_dir=base, wal_enabled=True,
                vector_index_factory=lambda: FlatIndex(dim, DistanceKind.L2),
                text_index_factory=BM25SearchIndex,
                metadata_index_factory=RoaringMetadataIndex,
            )

        texts = _texts(n, cfg.seed)
        store = open_persistent_hybrid_index(config())
        t0 = time.perf_counter()
        doc_ids = store.add_batch(
            (ctx.corpus[i], texts[i], {"cat": "abcd"[i % 4]}) for i in range(n)
        )
        store.flush()
        store.close()
        t_write = time.perf_counter() - t0
        store = open_persistent_hybrid_index(config())
        t0 = time.perf_counter()
        try:
            results = [
                store.new_search().with_vector(ctx.queries[qi])
                .with_k(cfg.store_k).execute()
                for qi in range(cfg.store_check)
            ]
        finally:
            store.close()
        t_read = time.perf_counter() - t0
        log(f"  store: add_batch + flush + close({n}) {t_write:.2f} s; "
            f"reopen + {cfg.store_check} searches {t_read:.2f} s")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    row_of = {d: i for i, d in enumerate(doc_ids)}
    ids = np.zeros((cfg.store_check, cfg.store_k), np.int64)
    sc = np.zeros((cfg.store_check, cfg.store_k))
    for qi, hits in enumerate(results):
        ids[qi, : len(hits)] = [row_of.get(h.id, -2) + 1 for h in hits]
        sc[qi, : len(hits)] = [h.score for h in hits]
    res = check_exact("store", ids, sc, ctx.oracle.sq[: cfg.store_check, :n],
                      cfg.store_k, ctx.oracle.bound)
    return res


PHASES = {
    "flat": phase_flat,
    "ivf": phase_ivf,
    "pq": phase_pq,
    "ivfpq": phase_ivfpq,
    "hnsw": phase_hnsw,
    "hybrid": phase_hybrid,
    "store": phase_store,
}


# -- four cards --------------------------------------------------------------


def phase_four_cards(ctx) -> dict:
    """comet_tpu.parallel on a 1-D mesh over all four cards, 1M rows per
    card, each searcher compared with its single-device index on card 0."""
    import jax
    import jax.numpy as jnp

    from comet_tpu import (
        BM25SearchIndex, DistanceKind, FlatIndex, FusionKind, IVFIndex,
        RoaringMetadataIndex, new_hybrid_search_index,
    )
    from comet_tpu.indexes.metadata import eq
    from comet_tpu.parallel.sharded import (
        ShardedFlatSearcher, ShardedHybridSearcher, ShardedIVFSearcher,
        make_corpus_mesh, make_sharded_kmeans_step, shard_rows,
    )

    cfg = ctx.cfg
    devices = jax.devices()
    mesh = make_corpus_mesh(devices)
    log(f"  mesh: {mesh.shape} over {[d.id for d in devices]}")
    corpus, q, n, k = ctx.corpus, ctx.queries, cfg.rows, cfg.k
    c = ctx.check
    out = {}

    def on_all(arr, what):
        where = {s.device.id for s in arr.addressable_shards}
        if len(where) != len(devices):
            raise PhaseError(f"{what} lives on devices {sorted(where)} only")

    # flat
    t0 = time.perf_counter()
    sh_flat = ShardedFlatSearcher(mesh, corpus, DistanceKind.L2)
    on_all(sh_flat.corpus, "sharded flat corpus")
    log(f"  sharded flat: corpus sharded in {time.perf_counter() - t0:.2f} s")
    (s, slots), t = timed_search(
        "sharded flat search", lambda: sh_flat.search(q, k), len(q), ctx.card)
    out["flat"] = {**check_exact("sharded flat", slots[:c] + 1, s[:c],
                                 ctx.oracle.sq, k, ctx.oracle.bound), **t}
    with jax.default_device(devices[0]):
        single = FlatIndex(corpus.shape[1], DistanceKind.L2)
        single.add_batch(corpus, ids=ctx.ids)
        (ids1, _), t1 = timed_search(
            "single-card flat search (card 0)",
            lambda: single.search_batch(q, k=k), len(q), ctx.card)
    agree = float(np.mean(ids1 == (slots + 1)))
    log(f"  sharded flat vs single card: {agree:.6f} of ids equal")
    out["flat_single_qps"] = t1["qps"]
    out["flat_agree"] = agree
    del single

    # one k-means step over the mesh (psum of per-card partial sums) vs the
    # same step in float64 on the host
    x = corpus[: cfg.train_rows]
    init = x[: cfg.nlist]
    step = make_sharded_kmeans_step(mesh, DistanceKind.L2_SQUARED)
    rows_pad = -(-len(x) // len(devices)) * len(devices)
    xp = np.zeros((rows_pad, x.shape[1]), np.float32)
    xp[: len(x)] = x
    valid = np.arange(rows_pad) < len(x)
    xs, vs, prev = shard_rows(mesh, xp, valid,
                              np.full(rows_pad, -1, np.int32))
    on_all(xs, "sharded k-means rows")
    assign, cents, _ = step(xs, vs, prev, jnp.asarray(init))
    assign = np.asarray(assign)[: len(x)]
    cents = np.asarray(cents)
    x64 = x.astype(np.float64)
    d64 = ((x64 * x64).sum(1)[:, None] + (init.astype(np.float64) ** 2).sum(1)
           - 2.0 * x64 @ init.T.astype(np.float64))
    a64 = np.argmin(d64, axis=1)
    a_agree = float(np.mean(a64 == assign))
    sums = np.zeros_like(init, dtype=np.float64)
    np.add.at(sums, assign, x64)
    counts = np.bincount(assign, minlength=len(init))[:, None]
    c64 = np.where(counts > 0, sums / np.maximum(counts, 1), init)
    c_err = float(np.abs(c64 - cents).max())
    log(f"  sharded k-means step: assignments {a_agree:.6f} equal to the "
        f"float64 step's, centroid max |diff| {c_err:.3g} (same assignment)")
    if a_agree < 0.999 or c_err > 1e-2:
        raise PhaseError("sharded k-means step disagrees with the reference")
    out["kmeans"] = {"assign_agree": a_agree, "centroid_err": c_err}

    # IVF
    with jax.default_device(devices[0]):
        ivf = IVFIndex(corpus.shape[1], cfg.nlist, DistanceKind.L2)
        ivf.train(corpus[: cfg.train_rows])
        ivf.add_batch(corpus, ids=ctx.ids)
        (ids1, _), t1 = timed_search(
            "single-card ivf search (card 0)",
            lambda: ivf.search_batch(q, k=k, nprobes=cfg.ivf_nprobe),
            len(q), ctx.card)
    sh_ivf = ShardedIVFSearcher(mesh, ivf)
    on_all(sh_ivf.corpus, "sharded ivf corpus")
    (s, slots), t = timed_search(
        "sharded ivf search",
        lambda: sh_ivf.search(q, k, nprobe=cfg.ivf_nprobe), len(q), ctx.card)
    got = np.where(slots >= 0, sh_ivf.row_ids[np.clip(slots, 0, n - 1)], 0)
    want, keep = ivf_oracle(ivf, ctx, cfg.ivf_nprobe)
    out["ivf"] = {**check_exact("sharded ivf", got[keep], s[keep], want, k,
                                ctx.oracle.bound), **t}
    agree = float(np.mean(ids1 == got))
    log(f"  sharded ivf vs single card: {agree:.6f} of ids equal")
    out["ivf_single_qps"] = t1["qps"]
    del ivf, sh_ivf

    # hybrid over the sharded flat searcher: metadata on every row, text on
    # the first hybrid_rows docs
    nh = min(cfg.hybrid_rows, n)
    text_idx = BM25SearchIndex(wordlike_only=True)
    text_idx.add_batch([int(i) for i in ctx.ids[:nh]], _texts(nh, cfg.seed))
    meta_idx = RoaringMetadataIndex()
    meta_idx.add_columns(ctx.ids.astype(np.uint64),
                         {"cat": np.array(list("abcd"))[np.arange(n) % 4]})
    sh_h = ShardedHybridSearcher(sh_flat, ctx.ids, text_index=text_idx,
                                 metadata_index=meta_idx)
    ref = new_hybrid_search_index(
        _oracle_flat_class()(corpus.shape[1], DistanceKind.L2), text_idx,
        meta_idx)
    ref.vector_index().add_batch(corpus, ids=ctx.ids)
    qt = [f"w{i % 50} w{(i * 13) % 500}" for i in range(c)]
    kw = dict(k=cfg.hybrid_k, metadata_filters=[eq("cat", "a")],
              fusion_kind=FusionKind.RECIPROCAL_RANK)
    got_h, t = timed_search("sharded hybrid search",
                            lambda: sh_h.search_batch(q[:c], qt, **kw), c,
                            ctx.card)
    want_h = ref.search_batch(q[:c], qt, **kw)
    v_sc, v_slots = sh_flat.search(q[:c], cfg.hybrid_k,
                                   allowed=np.arange(n) % 4 == 0)
    v_want, _ = ref.vector_index().search_batch(
        q[:c], k=cfg.hybrid_k,
        document_ids=np.flatnonzero(np.arange(n) % 4 == 0) + 1)
    log(f"  sharded hybrid: {n} vectors with metadata, {nh} with text")
    out["hybrid"] = {**check_hybrid("sharded hybrid", got_h, want_h,
                                    (v_slots + 1, v_sc, v_want), ctx, n), **t}
    return out


# -- driver ------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    cfg: Config
    corpus: np.ndarray
    queries: np.ndarray
    ids: np.ndarray
    oracle: Oracle
    card: str

    @property
    def check(self) -> int:
        return self.oracle.sq.shape[0]


def make_context(cfg: Config, card: str) -> Context:
    corpus, queries = make_data(cfg)
    oracle = Oracle(corpus, queries[: cfg.check])
    ids = np.arange(1, len(corpus) + 1, dtype=np.uint32)
    return Context(cfg, corpus, queries, ids, oracle, card)


def run_phases(ctx: Context, phases) -> list[str]:
    """Run each phase; returns the names of those that failed. A failure is
    printed and recorded, never swallowed."""
    failed = []
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name} FAILED")
        else:
            log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    return failed


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the comet_tpu.parallel path on 4 GPUs, "
                        "1M rows per card")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          os.path.join(REPO, ".jax_cache"))
    sys.path.insert(0, REPO)
    import jax

    from comet_tpu import native
    from comet_tpu.utils.device import NoGPUError, card_power, require_gpu

    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    card = card_power().replace("\n", " | ")
    log(f"card: {card}")
    log(f"jax {jax.__version__}; device {device}; native C helpers "
        f"{'loaded' if native.available() else 'NOT loaded (numpy fallback)'}")
    cfg = Config(seed=args.seed)
    if args.four_cards:
        if device["count"] < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, have "
                  f"{device['count']}", file=sys.stderr)
            return 1
        cfg.data = "gen_data"
        cfg.rows = 4 * cfg.rows
        phases = [("four_cards", phase_four_cards)]
    else:
        phases = list(PHASES.items())
    log({"siftgen": "data: io/siftgen (SIFT descriptors of synthetic "
                    "images)",
         "gen_data": "data: bench.gen_data (Gaussian mixture, 1024 "
                     "centres, intrinsic dim 16)"}[cfg.data]
        + f", seed {cfg.seed}")
    t0 = time.perf_counter()
    ctx = make_context(cfg, card)
    log(f"data + float64 oracle ({cfg.rows} x {ctx.corpus.shape[1]}, "
        f"{ctx.check} check queries): {time.perf_counter() - t0:.1f} s")
    failed = run_phases(ctx, phases)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
