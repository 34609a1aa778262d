"""BM25 full-text index.

Capability parity with the reference's BM25SearchIndex (bm25_index.go,
bm25_index_search.go): K1=1.2 / B=0.75 (bm25_index.go:75-80), NFKC +
lowercase normalization (bm25_index.go:154-156), word tokenization,
IDF = log((N-df+0.5)/(df+0.5)+1) with TF saturation
(bm25_index_search.go:299-327), add-replaces-existing, soft delete (counts
unchanged until flush, bm25_index.go:253-278,374-399), node-based
"more-like-this" queries reconstructed from stored tokens
(bm25_index_search.go:233-261), multi-query aggregation / k / autocut /
doc-ID filters, and binary serialization.

Tokenizer: true UAX#29 word segmentation (indexes/uax29.py), yielding ALL
segments — including punctuation and whitespace runs — exactly like the
reference's words.FromString loop (bm25_index.go:159-166): contractions
("don't"), numerics ("1,000.50"), domains ("example.com") stay single
tokens; doc lengths count every segment. Pass wordlike_only=True to filter
to letter/digit-bearing segments instead (a quality knob the reference
lacks).

Engine: postings build incrementally into per-term (doc, tf) arrays; a
query scores by accumulating vectorized per-term contributions into a dense
score vector (one fused numpy pass per term — the reference iterates
roaring bitmaps doc-by-doc). Deletions/filters are packed-bitset masks.
"""

from __future__ import annotations

import math
import threading
import unicodedata
from typing import BinaryIO, Iterable

import numpy as np

from comet_tpu.core.aggregation import aggregate_scores
from comet_tpu.core.filter import DocumentFilter
from comet_tpu.core.limiter import autocut_results, limit_results
from comet_tpu.core.results import TextResult
from comet_tpu.indexes import uax29
from comet_tpu.io import serial
from comet_tpu.ops.bitset import Bitset
from comet_tpu.utils.memory import memory_report
from comet_tpu.types import (
    InvalidConfigError,
    NodeNotFoundError,
    ScoreAggregationKind,
)

MAGIC = b"CB25"
# v2: explicit per-doc token lists (v1 joined tokens with " " and
# re-tokenized on load — lossy once whitespace runs are themselves tokens)
VERSION = 3  # v3: CRC32 payload trailer (v2 readable, no trailer check)

K1 = 1.2  # bm25_index.go:75-80
B = 0.75

def normalize(text: str) -> str:
    """NFKC + lowercase (bm25_index.go:154-156)."""
    return unicodedata.normalize("NFKC", text).lower()


def tokenize(text: str) -> list[str]:
    """ALL UAX#29 word segments — whitespace and punctuation included —
    matching the reference's unfiltered words.FromString loop
    (bm25_index.go:159-166). See indexes/uax29.py."""
    return uax29.segment(text)


class _Postings:
    """Per-term postings with incremental build + compiled array cache."""

    __slots__ = ("tf", "_ids", "_tfs", "_dirty")

    def __init__(self):
        self.tf: dict[int, int] = {}
        self._ids: np.ndarray | None = None
        self._tfs: np.ndarray | None = None
        self._dirty = True

    def bump(self, doc_id: int, count: int = 1) -> None:
        self.tf[doc_id] = self.tf.get(doc_id, 0) + count
        self._dirty = True

    def drop(self, doc_id: int) -> None:
        if self.tf.pop(doc_id, None) is not None:
            self._dirty = True

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        if self._dirty:
            if self.tf:
                ids = np.fromiter(self.tf.keys(), dtype=np.uint32, count=len(self.tf))
                tfs = np.fromiter(self.tf.values(), dtype=np.float64, count=len(self.tf))
            else:
                ids = np.zeros(0, dtype=np.uint32)
                tfs = np.zeros(0, dtype=np.float64)
            self._ids, self._tfs = ids, tfs
            self._dirty = False
        return self._ids, self._tfs

    @property
    def df(self) -> int:
        return len(self.tf)


POSTING_CHUNK = 512  # postings split into fixed-size chunks for device gathers


class BM25SearchIndex:
    """BM25 text index (reference: bm25_index.go:98-122)."""

    def __init__(self, wordlike_only: bool = False):
        # wordlike_only=True filters segments to letter/digit-bearing ones
        # (quality knob; the reference indexes every segment). The flag is
        # NOT serialized — use the same setting when reloading.
        self._wordlike_only = wordlike_only
        self._postings: dict[str, _Postings] = {}
        self._doc_tokens: dict[int, list[str]] = {}
        self._doc_len: dict[int, int] = {}
        self._deleted = Bitset()
        self._num_docs = 0
        self._total_tokens = 0
        self._lock = threading.RLock()
        self._len_version = 0
        self._len_cache: tuple[int, np.ndarray] | None = None
        self._dev_version = -1
        self._dev = None  # (chunk_docs, chunk_tf, doc_len, term_chunks, n_pad)
        self._host_version = -1
        self._host = None  # (docs, tfs, term ranges, doc_len) for native

    def _tokenize(self, text: str) -> list[str]:
        toks = tokenize(normalize(text))
        if self._wordlike_only:
            toks = uax29.wordlike(toks)
        return toks

    # -- contracts -----------------------------------------------------------

    def trained(self) -> bool:
        return True

    def train(self, *_args) -> None:
        return None

    def count(self) -> int:
        """Active (non-soft-deleted) document count."""
        with self._lock:
            return self._num_docs - self._deleted.count()

    @property
    def avg_doc_len(self) -> float:
        with self._lock:
            return self._total_tokens / self._num_docs if self._num_docs else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "kind": "bm25",
                "docs": self._num_docs,
                "soft_deleted": self._deleted.count(),
                "terms": len(self._postings),
                "total_tokens": self._total_tokens,
                "avg_doc_len": self.avg_doc_len,
                "memory": memory_report(self),
            }

    # -- mutation --------------------------------------------------------------

    def add(self, doc_id: int, text: str) -> None:
        """Index a document; replaces an existing doc with the same ID
        (bm25_index.go:188-226)."""
        with self._lock:
            self._add_tokens(int(doc_id), self._tokenize(text))

    def _add_tokens(self, doc_id: int, tokens: list[str]) -> None:
        """Index pre-tokenized content (caller holds the lock)."""
        if doc_id in self._doc_tokens:
            self._remove_internal(doc_id)
        self._deleted.discard(doc_id)
        self._doc_tokens[doc_id] = tokens
        self._doc_len[doc_id] = len(tokens)
        self._num_docs += 1
        self._total_tokens += len(tokens)
        for t in tokens:
            p = self._postings.get(t)
            if p is None:
                p = self._postings[t] = _Postings()
            p.bump(doc_id)
        self._len_version += 1

    def add_batch(self, ids: Iterable[int], texts: Iterable[str]) -> None:
        """Bulk indexing: one postings update per UNIQUE (term, doc) pair
        (a Counter per doc collapses repeated terms before the dict work,
        ~1.7x the per-doc add loop on zipf-distributed text)."""
        from collections import Counter

        with self._lock:
            for doc_id, text in zip(ids, texts):
                doc_id = int(doc_id)
                if doc_id in self._doc_tokens:
                    self._remove_internal(doc_id)
                self._deleted.discard(doc_id)
                tokens = self._tokenize(text)
                self._doc_tokens[doc_id] = tokens
                self._doc_len[doc_id] = len(tokens)
                self._num_docs += 1
                self._total_tokens += len(tokens)
                for t, c in Counter(tokens).items():
                    p = self._postings.get(t)
                    if p is None:
                        p = self._postings[t] = _Postings()
                    p.bump(doc_id, c)
            self._len_version += 1

    def remove(self, doc_id: int) -> None:
        """Soft delete: scoring skips the doc, but N/df/avgdl keep counting it
        until flush (parity: bm25_index.go:253-278)."""
        with self._lock:
            doc_id = int(doc_id)
            if doc_id not in self._doc_tokens or self._deleted.contains(doc_id):
                return
            self._deleted.add(doc_id)

    def _remove_internal(self, doc_id: int) -> None:
        tokens = self._doc_tokens.pop(doc_id, None)
        if tokens is None:
            return
        doc_len = self._doc_len.pop(doc_id)
        for t in set(tokens):
            p = self._postings.get(t)
            if p is not None:
                p.drop(doc_id)
                if not p.tf:
                    del self._postings[t]
        self._num_docs -= 1
        self._total_tokens -= doc_len
        if self._num_docs <= 0:
            self._num_docs = 0
            self._total_tokens = 0
        self._len_version += 1

    def flush(self) -> None:
        """Hard-delete all soft-deleted docs (bm25_index.go:374-399)."""
        with self._lock:
            for doc_id in self._deleted.to_array().tolist():
                self._remove_internal(int(doc_id))
            self._deleted = Bitset()

    # -- search ---------------------------------------------------------------

    def new_search(self) -> "BM25SearchBuilder":
        return BM25SearchBuilder(self)

    def _doc_len_array(self) -> np.ndarray:
        """Dense doc-length array [max_id+1] (rebuilt on change)."""
        if self._len_cache is None or self._len_cache[0] != self._len_version:
            size = (max(self._doc_len) + 1) if self._doc_len else 1
            arr = np.zeros(size, dtype=np.float64)
            for d, l in self._doc_len.items():
                arr[d] = l
            self._len_cache = (self._len_version, arr)
        return self._len_cache[1]

    def _search_single(
        self,
        query: str,
        doc_filter: DocumentFilter,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One query -> (doc_ids, scores) of ALL matching docs, unsorted.

        Mirrors the scoring loop at bm25_index_search.go:299-327, but each
        term contributes one vectorized pass over its postings arrays.
        """
        qtokens = self._tokenize(query)
        n = float(self._num_docs)
        if not qtokens or n == 0:
            return np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=np.float64)

        doc_len = self._doc_len_array()
        avgdl = self._total_tokens / n
        size = len(doc_len)
        scores = np.zeros(size, dtype=np.float64)
        touched = np.zeros(size, dtype=bool)

        for t in qtokens:
            p = self._postings.get(t)
            if p is None:
                continue
            df = float(p.df)
            idf = math.log((n - df + 0.5) / (df + 0.5) + 1.0)
            ids, tfs = p.arrays()
            dl = doc_len[ids]
            contrib = idf * (tfs * (K1 + 1.0)) / (
                tfs + K1 * (1.0 - B + B * (dl / avgdl))
            )
            scores[ids] += contrib
            touched[ids] = True

        # mask soft-deleted + doc filter
        cand = np.flatnonzero(touched).astype(np.uint32)
        if cand.size:
            keep = ~self._deleted.contains_many(cand)
            if doc_filter.enabled:
                keep &= doc_filter.slot_mask(cand)
            cand = cand[keep]
        return cand, scores[cand]

    # -- native scoring path (host C kernel) -----------------------------------

    def _host_postings(self):
        """Flat concatenated postings for the native batch scorer, rebuilt
        when contents change: (docs i32 [P], tfs f32 [P],
        term -> (start, len, df), doc_len f32 [n_pad64])."""
        if self._host_version == self._len_version and self._host is not None:
            return self._host
        parts_d, parts_t = [], []
        ranges: dict[str, tuple[int, int, int]] = {}
        pos = 0
        for term, p in self._postings.items():
            ids, tfs = p.arrays()
            parts_d.append(ids.astype(np.int32))
            parts_t.append(tfs.astype(np.float32))
            ranges[term] = (pos, len(ids), p.df)
            pos += len(ids)
        docs = (
            np.concatenate(parts_d) if parts_d else np.zeros(0, dtype=np.int32)
        )
        tfs = (
            np.concatenate(parts_t) if parts_t else np.zeros(0, dtype=np.float32)
        )
        max_doc = int(max(self._doc_len)) if self._doc_len else 0
        if max_doc >= 1 << 31:
            # doc ids past int32 would wrap in the native arrays; disable
            # the native path rather than score (or index) garbage
            self._host = (None, None, None, None)
            self._host_version = self._len_version
            return self._host
        n_pad = ((max_doc + 1 + 63) // 64) * 64
        doc_len = np.zeros(n_pad, dtype=np.float32)
        dl = self._doc_len_array()
        doc_len[: len(dl)] = dl
        self._host = (docs, tfs, ranges, doc_len)
        self._host_version = self._len_version
        return self._host

    def _native_search_batch(self, queries, k, document_ids):
        """Batch scoring on the host C kernel; None when native is absent.

        Posting iteration is irregular pointer work that a host C loop
        walks sequentially — this is the one hot path that stays
        native-host.
        """
        from comet_tpu import native

        if not native.available():
            return None
        docs, tfs, ranges, doc_len = self._host_postings()
        if docs is None:  # doc ids exceed the native int32 range
            return None
        n = float(self._num_docs)
        avgdl = self._total_tokens / n

        starts, lens, idfs, qoff = [], [], [], [0]
        for qtext in queries:
            for t in self._tokenize(qtext):
                r = ranges.get(t)
                if r is None:
                    continue
                start, length, df = r
                starts.append(start)
                lens.append(length)
                idfs.append(math.log((n - df + 0.5) / (df + 0.5) + 1.0))
            qoff.append(len(starts))

        n_pad = len(doc_len)
        words = n_pad // 64
        allowed = np.full(words, ~np.uint64(0), dtype=np.uint64)
        dw = self._deleted.words
        m = min(len(dw), words)
        allowed[:m] &= ~dw[:m]
        doc_filter = DocumentFilter(document_ids)
        fw = doc_filter.word_mask(words)
        if fw is not None:
            allowed &= fw

        out = native.bm25_score_topk(
            docs, tfs,
            np.asarray(starts, dtype=np.int64),
            np.asarray(lens, dtype=np.int64),
            np.asarray(idfs, dtype=np.float32),
            np.asarray(qoff, dtype=np.int64),
            doc_len, avgdl, K1, B, allowed, int(k),
        )
        if out is None:
            return None
        ids, scores = out
        from comet_tpu.indexes.base import INVALID_ID

        miss = ids < 0
        return (
            np.where(miss, INVALID_ID, ids).astype(np.uint32),
            np.where(miss, 0.0, scores).astype(np.float32),
        )

    # -- device scoring path --------------------------------------------------

    def _device_postings(self):
        """Chunked dense postings in HBM: every term's (doc, tf) arrays split
        into POSTING_CHUNK-entry chunks, concatenated into [NC, C] tables.
        A query gathers its terms' chunk rows and scatter-adds BM25
        contributions into a dense per-query score vector — the "dense padded
        postings" device plan from SURVEY.md §7.7."""
        import jax.numpy as jnp

        from comet_tpu.indexes.base import next_pow2

        if self._dev_version == self._len_version and self._dev is not None:
            return self._dev
        C = POSTING_CHUNK
        doc_arrays = []
        tf_arrays = []
        term_chunks: dict[str, np.ndarray] = {}
        nc = 0
        for term in self._postings:
            ids, tfs = self._postings[term].arrays()
            n_chunks = max((len(ids) + C - 1) // C, 1)
            docs = np.full((n_chunks, C), -1, dtype=np.int32)
            tfv = np.zeros((n_chunks, C), dtype=np.float32)
            docs.reshape(-1)[: len(ids)] = ids
            tfv.reshape(-1)[: len(ids)] = tfs
            doc_arrays.append(docs)
            tf_arrays.append(tfv)
            term_chunks[term] = np.arange(nc, nc + n_chunks, dtype=np.int32)
            nc += n_chunks
        if nc == 0:
            doc_arrays = [np.full((1, C), -1, dtype=np.int32)]
            tf_arrays = [np.zeros((1, C), dtype=np.float32)]
            nc = 1
        chunk_docs = jnp.asarray(np.concatenate(doc_arrays))
        chunk_tf = jnp.asarray(np.concatenate(tf_arrays))
        n_pad = next_pow2((max(self._doc_len) + 1) if self._doc_len else 1, 8)
        doc_len = np.zeros(n_pad, dtype=np.float32)
        dl = self._doc_len_array()
        doc_len[: len(dl)] = dl
        self._dev = (chunk_docs, chunk_tf, jnp.asarray(doc_len), term_chunks, n_pad)
        self._dev_version = self._len_version
        return self._dev

    def search_batch(
        self,
        queries: list[str],
        k: int = 10,
        document_ids=None,
        *,
        aggregation=None,
        cutoff: int = -1,
        group_size: int = 1,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Throughput API: each query string scores independently.

        Returns (ids [Q, k] uint32, scores [Q, k] f32); empty slots hold
        id == 0xFFFFFFFF / score == 0. Scoring runs on device: chunk gathers
        + scatter-add into dense per-query score rows + top-k.

        `cutoff` / `group_size` / `aggregation` mirror the fluent pipeline's
        post-steps per row (descending text semantics, aggregation.go:281):
        see BaseVectorIndex.search_batch (VERDICT r3 #6).
        """
        from comet_tpu.indexes.base import postprocess_batch_rows

        ids, scores = self._search_batch_core(queries, k, document_ids)
        return postprocess_batch_rows(
            ids, scores, k,
            aggregation=aggregation, cutoff=cutoff, group_size=group_size,
            ascending=False, empty_score=0.0,
        )

    def _search_batch_core(
        self,
        queries: list[str],
        k: int = 10,
        document_ids=None,
    ) -> tuple[np.ndarray, np.ndarray]:
        import jax
        import jax.numpy as jnp

        from comet_tpu.indexes.base import INVALID_ID, next_pow2

        with self._lock:
            n = float(self._num_docs)
            if n == 0:
                q = len(queries)
                return (
                    np.full((q, k), INVALID_ID, dtype=np.uint32),
                    np.zeros((q, k), dtype=np.float32),
                )
            native_out = self._native_search_batch(queries, k, document_ids)
            if native_out is not None:
                return native_out
            chunk_docs, chunk_tf, doc_len, term_chunks, n_pad = self._device_postings()
            avgdl = self._total_tokens / n

            rows_chunks = []
            rows_idf = []
            for qtext in queries:
                cids = []
                idfs = []
                for t in self._tokenize(qtext):
                    p = self._postings.get(t)
                    chunks = term_chunks.get(t)
                    if p is None or chunks is None:
                        continue
                    idf = math.log((n - p.df + 0.5) / (p.df + 0.5) + 1.0)
                    cids.extend(chunks.tolist())
                    idfs.extend([idf] * len(chunks))
                rows_chunks.append(cids)
                rows_idf.append(idfs)
            mc = next_pow2(max((len(c) for c in rows_chunks), default=1), 4)
            q_n = len(queries)
            chunk_ids = np.full((q_n, mc), -1, dtype=np.int32)
            chunk_idf = np.zeros((q_n, mc), dtype=np.float32)
            for i, (cids, idfs) in enumerate(zip(rows_chunks, rows_idf)):
                chunk_ids[i, : len(cids)] = cids
                chunk_idf[i, : len(idfs)] = idfs

            allowed = np.ones(n_pad, dtype=bool)
            if not self._deleted.is_empty():
                deleted_dense = np.unpackbits(
                    self._deleted.words.view(np.uint8), bitorder="little"
                )
                m = min(len(deleted_dense), n_pad)
                allowed[:m] &= deleted_dense[:m] == 0
            doc_filter = DocumentFilter(document_ids)
            fmask = doc_filter.slot_mask(np.arange(n_pad, dtype=np.uint32))
            if fmask is not None:
                allowed &= fmask

            scores, ids = _bm25_device_kernel(
                jnp.asarray(chunk_ids), jnp.asarray(chunk_idf),
                chunk_docs, chunk_tf, doc_len, jnp.asarray(allowed),
                jnp.asarray(np.float32(avgdl)), min(k, n_pad),
            )
        scores = np.asarray(scores)
        ids = np.asarray(ids).astype(np.uint32)
        miss = scores <= 0.0
        ids = np.where(miss, INVALID_ID, ids)
        scores = np.where(miss, 0.0, scores)
        if ids.shape[1] < k:
            pad = k - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=INVALID_ID)
            scores = np.pad(scores, ((0, 0), (0, pad)))
        return ids, scores

    def _lookup_node_texts(self, node_ids: list[int]) -> list[str]:
        """More-like-this: rebuild query text from stored tokens
        (bm25_index_search.go:233-261)."""
        out = []
        for node_id in node_ids:
            node_id = int(node_id)
            if node_id not in self._doc_tokens or self._deleted.contains(node_id):
                raise NodeNotFoundError(f"document ID {node_id} not found in index")
            out.append(" ".join(self._doc_tokens[node_id]))
        return out

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CB25 v2: explicit per-doc token lists (postings are rebuilt on
        load — tokens round-trip verbatim, including whitespace segments).
        Flushes soft deletes first."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_u64(w, len(self._doc_tokens))
            for doc_id in sorted(self._doc_tokens):
                serial.write_u32(w, doc_id)
                tokens = self._doc_tokens[doc_id]
                serial.write_u32(w, len(tokens))
                for t in tokens:
                    serial.write_str(w, t)
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        n = serial.read_u64(r)
        docs = []
        for _ in range(n):
            doc_id = serial.read_u32(r)
            ntok = serial.read_u32(r)
            docs.append((doc_id, [serial.read_str(r) for _ in range(ntok)]))
        if version >= 3:
            r.verify()
        with self._lock:
            wordlike = self._wordlike_only
            self.__init__(wordlike_only=wordlike)
            for doc_id, tokens in docs:
                self._add_tokens(doc_id, tokens)


def _bm25_device_kernel(
    chunk_ids, chunk_idf, chunk_docs, chunk_tf, doc_len, allowed, avgdl, k
):
    """Jitted BM25 scorer: [Q, MC] chunk gathers -> scatter-add -> top-k."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnames=("k",))
    def kernel(chunk_ids, chunk_idf, chunk_docs, chunk_tf, doc_len, allowed, avgdl, k):
        q_n, mc = chunk_ids.shape
        n_pad = doc_len.shape[0]
        safe = jnp.maximum(chunk_ids, 0)
        docs = chunk_docs[safe]                       # [Q, MC, C]
        tf = chunk_tf[safe]
        ok = (chunk_ids[:, :, None] >= 0) & (docs >= 0)
        dl = doc_len[jnp.maximum(docs, 0)]
        contrib = chunk_idf[:, :, None] * (tf * (K1 + 1.0)) / (
            tf + K1 * (1.0 - B + B * (dl / avgdl))
        )
        contrib = jnp.where(ok, contrib, 0.0)
        q_rows = jax.lax.broadcasted_iota(jnp.int32, docs.shape, 0)
        scores = jnp.zeros((q_n, n_pad), jnp.float32).at[
            q_rows, jnp.maximum(docs, 0)
        ].add(contrib)
        scores = jnp.where(allowed[None, :], scores, 0.0)
        vals, ids = jax.lax.top_k(scores, k)
        return vals, ids

    return kernel(
        chunk_ids, chunk_idf, chunk_docs, chunk_tf, doc_len, allowed, avgdl, k
    )


class BM25SearchBuilder:
    """Fluent text search (reference: bm25_index_search.go:19-175)."""

    def __init__(self, index: BM25SearchIndex):
        self._index = index
        self._queries: list[str] = []
        self._node_ids: list[int] = []
        self._k = 10
        self._aggregation = ScoreAggregationKind.SUM
        self._cutoff = -1
        self._document_ids: list[int] | None = None

    def with_query(self, *queries: str) -> "BM25SearchBuilder":
        self._queries.extend(queries)
        return self

    def with_node(self, *node_ids: int) -> "BM25SearchBuilder":
        self._node_ids.extend(int(i) for i in node_ids)
        return self

    def with_k(self, k: int) -> "BM25SearchBuilder":
        self._k = int(k)
        return self

    def with_score_aggregation(self, kind: ScoreAggregationKind) -> "BM25SearchBuilder":
        self._aggregation = ScoreAggregationKind(kind)
        return self

    def with_cutoff(self, cutoff: int) -> "BM25SearchBuilder":
        self._cutoff = int(cutoff)
        return self

    def with_document_ids(self, doc_ids) -> "BM25SearchBuilder":
        """Accepts an iterable of IDs or a packed Bitset (stays packed)."""
        if isinstance(doc_ids, Bitset):
            self._document_ids = doc_ids
        else:
            self._document_ids = [int(i) for i in doc_ids]
        return self

    def execute(self) -> list[TextResult]:
        if not self._queries and not self._node_ids:
            raise InvalidConfigError("must specify either queries or node IDs")

        with self._index._lock:
            queries = list(self._queries)
            if self._node_ids:
                queries.extend(self._index._lookup_node_texts(self._node_ids))

            doc_filter = DocumentFilter(self._document_ids)
            all_ids: list[np.ndarray] = []
            all_scores: list[np.ndarray] = []
            native_out = (
                self._index._native_search_batch(
                    queries, self._k, self._document_ids
                )
                if self._k > 0 and self._index._num_docs > 0
                else None
            )
            if native_out is not None:
                # C kernel: per-query top-k with the same (score desc,
                # id asc) tie order as the lexsort below
                from comet_tpu.indexes.base import INVALID_ID

                for row_i, row_s in zip(*native_out):
                    hit = row_i != INVALID_ID
                    if hit.any():
                        all_ids.append(row_i[hit])
                        all_scores.append(row_s[hit])
            else:
                for q in queries:
                    ids, scores = self._index._search_single(q, doc_filter)
                    if ids.size == 0:
                        continue
                    # per-query top-k BEFORE aggregation (parity with
                    # searchSingleQuery returning k results per query)
                    if 0 < self._k < ids.size:
                        order = np.lexsort((ids, -scores))[: self._k]
                        ids, scores = ids[order], scores[order]
                    all_ids.append(ids)
                    all_scores.append(scores)

        if not all_ids:
            return []
        ids = np.concatenate(all_ids)
        scores = np.concatenate(all_scores).astype(np.float32)
        uids, uscores = aggregate_scores(ids, scores, self._aggregation, ascending=False)
        results = [TextResult(int(i), float(s)) for i, s in zip(uids, uscores)]
        results = limit_results(results, self._k)
        results = autocut_results(results, self._cutoff)
        return results
