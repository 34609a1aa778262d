"""IVF (inverted file) vector index.

Capability parity with the reference's IVFIndex (ivf_index.go,
ivf_index_search.go): k-means-partitioned corpus, nprobe-limited exact scan
of the nearest inverted lists, soft delete + flush, thresholds/filters/
aggregation/autocut/rerankers, binary serialization. Defaults: train needs
>= nlist vectors (ivf_index.go:206-215), nprobe defaults to sqrt(nlist) and
sanitizes to nlist when out of range (ivf_index.go:410,
ivf_index_search.go:232-236).

Design: centroid ranking is one [Q, nlist] matmul + top-k; the probe scan
is a lockstep while_loop over fixed-size inverted-list chunks — each step
gathers one 256-row chunk of every query's current probed list, computes
masked distances as a batched matvec, and merges into the running [Q, k]
with the deterministic (score, slot) two-key sort. Thousands of queries
probe in lockstep; there is no per-query pointer chasing, and the gathered
rows track the probed lists' sizes.
"""

from __future__ import annotations

import math
from functools import partial
from typing import BinaryIO, Iterable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from comet_tpu.core.filter import DocumentFilter
from comet_tpu.core.limiter import sanitize_k
from comet_tpu.core.node import VectorNode, reserve_node_ids
from comet_tpu.indexes.base import (
    BaseVectorIndex,
    VectorSearchBuilder,
    next_pow2,
    pad_queries,
    upload_f32_exact,
    threshold_scalar,
)
from comet_tpu.io import serial
from comet_tpu.ops.distance import DEFAULT_PRECISION, pairwise_scores, preprocess
from comet_tpu.ops.kmeans import find_nearest_centroid, kmeans
from comet_tpu.ops.topk import IDX_SENTINEL, INF, merge_topk
from comet_tpu.types import (
    DistanceKind,
    InvalidConfigError,
    NotTrainedError,
    VectorIndexKind,
)

MAGIC = b"CIVF"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)

IVF_QUERY_CHUNK = 256
LIST_CHUNK = 256  # inverted-list rows per fixed-size chunk


@partial(
    jax.jit, static_argnames=("k", "kind", "nprobe", "max_steps", "coarse_kind")
)
def _ivf_search_kernel(
    queries: jax.Array,      # [Q, d]
    centroids: jax.Array,    # [nlist, d]
    chunk_slots: jax.Array,  # [NC, LIST_CHUNK] int32, -1 padded
    chunk_start: jax.Array,  # [nlist + 1] int32 (list l owns chunks [s_l, s_{l+1}))
    vectors: jax.Array,      # [cap, d]
    sqnorms: jax.Array,      # [cap]
    valid: jax.Array,        # [cap] bool
    threshold: jax.Array,    # scalar f32
    k: int,
    kind: DistanceKind,
    nprobe: int,
    max_steps: int,
    coarse_kind: DistanceKind | None = None,
):
    """Batched IVF probe-and-scan over FIXED-SIZE list chunks.

    K-means lists are unbalanced on real data, so a padded [nlist, maxlen]
    layout wastes most of its gather bandwidth on padding. Lists are instead
    stored as contiguous 256-row chunks; every query walks a cursor over its
    probed lists' chunk ranges inside one while_loop, so total gather work
    tracks the actual list sizes (± one chunk per probe) and queries that
    finish early idle under a mask. `coarse_kind` ranks the centroids in
    another metric than the scan (default: `kind`). Returns
    (scores [Q,k], slots [Q,k]).
    """
    Q = queries.shape[0]
    ckind = kind if coarse_kind is None else coarse_kind
    cd = pairwise_scores(queries, centroids, ckind)      # [Q, nlist]
    _, probes = lax.top_k(-cd, nprobe)                  # [Q, nprobe]

    qn = jnp.sum(queries * queries, axis=1, keepdims=True)  # [Q, 1]
    rows = jnp.arange(Q)

    def cond(state):
        step, probe_i, off, best_s, best_i = state
        return (step < max_steps) & jnp.any(probe_i < nprobe)

    def body(state):
        step, probe_i, off, best_s, best_i = state
        alive = probe_i < nprobe
        p = probes[rows, jnp.minimum(probe_i, nprobe - 1)]       # [Q]
        base = chunk_start[p]
        nch = chunk_start[p + 1] - base
        chunk = jnp.minimum(base + off, chunk_slots.shape[0] - 1)

        have = alive & (off < nch)  # empty lists scan nothing this step
        slots = jnp.where(have[:, None], chunk_slots[chunk], -1)  # [Q, C]
        slots_c = jnp.maximum(slots, 0)
        vecs = vectors[slots_c]                                    # [Q, C, d]
        sq = sqnorms[slots_c]
        ip = jnp.einsum(
            "qd,qcd->qc", queries, vecs,
            preferred_element_type=jnp.float32, precision=DEFAULT_PRECISION,
        )
        if kind == DistanceKind.COSINE:
            dist = 1.0 - jnp.clip(ip, -1.0, 1.0)
        else:
            dist = jnp.maximum(qn + sq - 2.0 * ip, 0.0)
            if kind == DistanceKind.L2:
                dist = jnp.sqrt(dist)
        ok = (slots >= 0) & valid[slots_c] & (dist <= threshold)
        dist = jnp.where(ok, dist, INF)
        kk = min(k, dist.shape[1])
        s, pos = lax.top_k(-dist, kk)
        s = -s
        slot_sel = jnp.take_along_axis(slots, pos, axis=1)
        slot_sel = jnp.where(s == INF, IDX_SENTINEL, slot_sel)
        best_s, best_i = merge_topk(best_s, best_i, s, slot_sel, k)

        # advance the cursor: next chunk of this list, or the next probe
        # (empty lists have nch == 0 and are skipped immediately)
        last_chunk = off + 1 >= nch
        probe_i = jnp.where(alive & last_chunk, probe_i + 1, probe_i)
        off = jnp.where(alive & last_chunk, 0, jnp.where(alive, off + 1, off))
        return step + 1, probe_i, off, best_s, best_i

    init = (
        jnp.int32(0),
        jnp.zeros(Q, jnp.int32),
        jnp.zeros(Q, jnp.int32),
        jnp.full((Q, k), INF, dtype=jnp.float32),
        jnp.full((Q, k), IDX_SENTINEL, dtype=jnp.int32),
    )
    state = lax.while_loop(cond, body, init)
    return state[3], state[4]


def build_chunked_lists(
    assign: np.ndarray, nlist: int, chunk: int = LIST_CHUNK
) -> tuple[np.ndarray, np.ndarray, int]:
    """Fixed-size chunked inverted lists from per-slot assignments.

    Returns (chunk_slots [NC_pad, chunk] int32 -1-padded,
             chunk_start [nlist+1] int32,
             max_chunks_per_list).
    """
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    pos0 = np.searchsorted(sorted_assign, 0)
    assigned = order[pos0:].astype(np.int32)
    lists = sorted_assign[pos0:]
    counts = np.bincount(lists, minlength=nlist) if len(lists) else np.zeros(
        nlist, dtype=np.int64
    )
    n_chunks = -(-counts // chunk)  # ceil; empty lists own 0 chunks
    chunk_start = np.zeros(nlist + 1, dtype=np.int32)
    np.cumsum(n_chunks, out=chunk_start[1:])
    nc = max(int(chunk_start[-1]), 1)
    nc_pad = next_pow2(nc, 4)
    chunk_slots = np.full((nc_pad, chunk), -1, dtype=np.int32)
    if len(assigned):
        starts = np.zeros(nlist, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        within = np.arange(len(assigned)) - starts[lists]
        rows = chunk_start[lists] + within // chunk
        cols = within % chunk
        chunk_slots[rows, cols] = assigned
    return chunk_slots, chunk_start, max(int(n_chunks.max()) if nlist else 1, 1)


class IVFIndex(BaseVectorIndex):
    """Inverted-file index (reference: ivf_index.go:82-119)."""

    def __init__(self, dim: int, nlist: int, distance_kind: DistanceKind = DistanceKind.L2):
        super().__init__(dim, distance_kind)
        if nlist <= 0:
            raise InvalidConfigError("nlist must be positive")
        self._nlist = nlist
        self._centroids: np.ndarray | None = None
        self._assign = np.full(self._store.capacity, -1, dtype=np.int32)
        self._trained = False
        # device bucket cache
        self._bucket_version = -1
        self._dev_chunks = None
        self._dev_chunk_start = None
        self._max_chunks = 1
        self._dev_centroids = None

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.IVF

    def trained(self) -> bool:
        return self._trained

    @property
    def nlist(self) -> int:
        return self._nlist

    def default_nprobes(self) -> int:
        """sqrt(nlist), the reference default (ivf_index.go:410)."""
        return int(math.sqrt(self._nlist))

    def stats(self) -> dict:
        s = super().stats()
        s["nlist"] = self._nlist
        s["trained"] = self._trained
        return s

    # -- training --------------------------------------------------------------

    def train(self, vectors: np.ndarray, max_iter: int = 20) -> None:
        """Learn the Voronoi partition via k-means (ivf_index.go:206-235).

        Requires at least nlist training vectors. Vectors already in the
        index are re-assigned to the new centroids (the reference leaves
        stale assignments; re-assigning is strictly better and keeps the
        exact-scan-within-probed-lists contract).
        """
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if len(vectors) < self._nlist:
            raise InvalidConfigError(
                f"need at least {self._nlist} training vectors for "
                f"{self._nlist} clusters (got {len(vectors)})"
            )
        prepped = preprocess(vectors, self._distance_kind)
        centroids, _ = kmeans(prepped, self._nlist, self._distance_kind, max_iter,
                              return_assign=False)
        with self._lock:
            self._centroids = centroids
            self._trained = True
            n = self._store.n
            if n:
                self._assign[:n] = find_nearest_centroid(
                    self._store.vectors[:n], centroids, self._distance_kind
                )
            self._bucket_version = -1

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Assign each vector to its nearest centroid list (ivf_index.go:251-280),
        batched: one [B, nlist] distance matmul instead of B scalar scans."""
        if not self._trained:
            raise NotTrainedError("index must be trained before adding vectors")
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if ids is None:
            first = reserve_node_ids(len(vectors))
            id_arr = np.arange(first, first + len(vectors), dtype=np.uint32)
        else:
            id_arr = np.asarray(list(ids), dtype=np.uint32)
            if len(id_arr) != len(vectors):
                raise InvalidConfigError("ids and vectors length mismatch")
        prepped = preprocess(vectors, self._distance_kind)
        assign = find_nearest_centroid(prepped, self._centroids, self._distance_kind)
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            if self._store.n + len(id_arr) > len(self._assign):
                grown = np.full(
                    next_pow2(self._store.n + len(id_arr), len(self._assign) * 2),
                    -1,
                    dtype=np.int32,
                )
                grown[: len(self._assign)] = self._assign
                self._assign = grown
            slots = self._store.add_batch(id_arr, prepped)
            self._assign[slots] = assign.astype(np.int32)
        return id_arr.tolist()

    def remove(self, node_id: int) -> None:
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        """Hard-delete and compact; list assignments follow the kept slots
        (parity with ivf_index.go:362-399)."""
        with self._lock:
            keep = self._store.flush()
            kept_assign = self._assign[keep]
            self._assign[: len(kept_assign)] = kept_assign
            self._assign[len(kept_assign):] = -1
            self._bucket_version = -1

    # -- search ---------------------------------------------------------------

    def _device_buckets(self):
        """Chunked inverted lists on device, rebuilt when contents change."""
        if self._bucket_version != self._store.version:
            n = self._store.n
            chunk_slots, chunk_start, max_chunks = build_chunked_lists(
                self._assign[:n], self._nlist
            )
            self._dev_chunks = jnp.asarray(chunk_slots)
            self._dev_chunk_start = jnp.asarray(chunk_start)
            self._max_chunks = max_chunks
            self._dev_centroids = jnp.asarray(self._centroids)
            self._bucket_version = self._store.version
        return (
            self._dev_centroids,
            self._dev_chunks,
            self._dev_chunk_start,
            self._max_chunks,
        )

    def _sanitize_nprobes(self, nprobes: int | None) -> int:
        if nprobes is None:
            nprobes = self.default_nprobes()
        if nprobes <= 0 or nprobes > self._nlist:
            nprobes = self._nlist
        return nprobes

    def _search_batch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        return self._search_collect(self._search_launch(queries, builder))

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        if not self._trained:
            raise NotTrainedError("index must be trained before searching")
        store = self._store
        n_slots = store.n
        if n_slots == 0:
            return ("empty", queries.shape[0])

        k_eff = sanitize_k(builder._k, n_slots)
        k_pad = min(next_pow2(k_eff), store.capacity)
        nprobe = self._sanitize_nprobes(builder._nprobes)

        qprep = preprocess(queries, self._distance_kind)
        qpad, q_real = pad_queries(qprep)

        vecs, sqnorms, valid = store.device_state()
        doc_filter = DocumentFilter(builder._document_ids)
        fmask = doc_filter.slot_mask(store.ids)
        if fmask is not None:
            valid = jnp.logical_and(valid, jnp.asarray(fmask))
        thr = threshold_scalar(builder._threshold)

        centroids, chunk_slots, chunk_start, max_chunks = self._device_buckets()
        max_steps = next_pow2(nprobe * max_chunks, 4)
        chunks = []
        for q0 in range(0, qpad.shape[0], IVF_QUERY_CHUNK):
            qc = upload_f32_exact(qpad[q0 : q0 + IVF_QUERY_CHUNK])
            chunks.append(
                _ivf_search_kernel(
                    qc, centroids, chunk_slots, chunk_start, vecs, sqnorms,
                    valid, thr, k_pad, self._distance_kind, nprobe, max_steps,
                )
            )
        return ("dev_chunks", chunks, q_real, k_eff, store.ids)

    def _search_collect(self, handle):
        from comet_tpu.indexes.base import collect_device_handle

        return collect_device_handle(handle)

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CIVF v1: params + centroids + ids/vectors/assignments (flushed)."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            serial.write_u32(w, self._nlist)
            serial.write_u32(w, 1 if self._trained else 0)
            if self._trained:
                serial.write_array(w, self._centroids)
            n = self._store.n
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            serial.write_array(w, self._store.vectors[:n])
            serial.write_array(w, self._assign[:n])
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        nlist = serial.read_u32(r)
        if kind != self._distance_kind:
            raise serial.SerializationError(
                f"distance kind mismatch: index={self._distance_kind.value}, stored={kind.value}"
            )
        if dim != self._dim:
            raise serial.SerializationError(f"dimension mismatch: index={self._dim}, stored={dim}")
        if nlist != self._nlist:
            raise serial.SerializationError(f"nlist mismatch: index={self._nlist}, stored={nlist}")
        trained = bool(serial.read_u32(r))
        centroids = serial.read_array(r) if trained else None
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        vectors = serial.read_array(r)
        assign = serial.read_array(r)
        if version >= 2:
            r.verify()
        if len(ids) != n or vectors.shape != (n, dim) or len(assign) != n:
            raise serial.SerializationError("corrupt IVF index payload")
        with self._lock:
            self._store = type(self._store)(dim, capacity=max(n, 1))
            self._assign = np.full(self._store.capacity, -1, dtype=np.int32)
            self._centroids = centroids
            self._trained = trained
            if n:
                slots = self._store.add_batch(ids.astype(np.uint32), vectors.astype(np.float32))
                self._assign[slots] = assign.astype(np.int32)
            self._bucket_version = -1
