"""Flat (brute-force exact) vector index.

Capability parity with the reference's FlatIndex (flat_index.go,
flat_index_search.go): exact kNN with soft delete + Flush compaction,
threshold / doc-ID pre-filter / multi-query aggregation / autocut / reranker,
and binary serialization.

Design: the corpus is a padded [capacity, d] float32 array in device
memory; search is `ops.topk.block_topk` — a query-chunk x corpus matmul
with the validity mask, doc-ID filter, and threshold fused into the
distance tile, followed by an exact block selection (group minima, top
groups, one small sort). The reference's per-vector scalar loop
(flat_index_search.go:254-274) is replaced wholesale, not translated.
"""

from __future__ import annotations

from typing import BinaryIO, Iterable

import jax.numpy as jnp
import numpy as np

from comet_tpu.core.filter import DocumentFilter
from comet_tpu.core.limiter import sanitize_k
from comet_tpu.core.node import VectorNode, reserve_node_ids
from comet_tpu.indexes.base import (
    BaseVectorIndex,
    INVALID_ID,
    VectorSearchBuilder,
    next_pow2,
    pad_queries,
    upload_f32_exact,
    threshold_scalar,
)
from comet_tpu.io import serial
from comet_tpu.ops.distance import preprocess
from comet_tpu.ops.topk import IDX_SENTINEL, block_topk
from comet_tpu.types import DistanceKind, InvalidConfigError, VectorIndexKind

MAGIC = b"CFLT"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)

# Corpus rows per scan step (the super tile is 8 of these): bounds the
# [QUERY_CHUNK, super_tile] f32 distance tile at 1 GB.
DEFAULT_TILE = 1 << 17

# Query rows per device dispatch (bounds the [Qc, super_tile] dist buffer).
QUERY_CHUNK = 256


class FlatIndex(BaseVectorIndex):
    """Exact brute-force kNN index (reference: flat_index.go:65-94).

    `storage` selects the device-resident precision: "float32" (default,
    bit-exact parity with the scalar-f32 reference incl. tie order),
    "bfloat16"/"float16" (half the memory traffic and single-pass
    half-precision matmuls — ~0.3% relative distance error, recall impact
    negligible on real datasets), or "int8" (symmetric abs-max quantization, a
    QUARTER of the f32 memory traffic; quantizer.go:180-247's Int8Quantizer —
    which the reference ships but never wires into any index — as actual index
    storage). The host-canonical copy stays float32 either way, so
    serialization and flush are lossless.

    int8 details: the scale is abs-max/127 — either trained once via
    `train(sample)` (fixed thereafter, like Int8Quantizer.Train) or, when
    untrained, fitted to the live corpus per mutation epoch. `rerank=True` adds
    an exact-f32 refinement: the int8 scan over-fetches `rerank_factor * k`
    candidates and the true top-k is recomputed from the float32 originals
    (host-side — the f32 corpus never occupies device memory), recovering exact
    distances at the cost of a slightly wider download.
    """

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        storage: str = "float32",
        rerank: bool = False,
        rerank_factor: int = 4,
    ):
        super().__init__(dim, distance_kind)
        if storage not in ("float32", "bfloat16", "float16", "int8"):
            raise InvalidConfigError(
                f"unsupported flat storage dtype: {storage!r} "
                "(use float32, bfloat16, float16, or int8)"
            )
        if rerank and storage == "float32":
            raise InvalidConfigError(
                "rerank=True needs lossy storage (the float32 scan is exact)"
            )
        self._storage = storage
        self._rerank = bool(rerank)
        self._rerank_factor = max(int(rerank_factor), 2)
        self._int8_scale = None        # trained scale (None = fit per epoch)
        self._dev_scale = None         # device copy of the epoch's scale
        self._dev_cast = None
        self._dev_cast_version = -1

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.FLAT

    def train(self, vectors=None) -> None:
        """Flat index requires no training (parity: flat Train is a no-op) —
        except int8 storage, where a training sample fixes the abs-max scale
        (quantizer.go Int8Quantizer.Train); untrained int8 fits the scale to
        the live corpus per mutation epoch instead."""
        if self._storage == "int8" and vectors is not None:
            sample = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
            self._check_dim(sample)
            prepped = preprocess(sample, self._distance_kind)
            amax = float(np.abs(prepped).max()) if prepped.size else 0.0
            with self._lock:
                self._int8_scale = np.float32(max(amax, 1e-30) / 127.0)
                self._dev_cast_version = -1  # requantize on next search
        return None

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        """Insert one node; the vector is preprocessed for the metric at
        insert time (flat_index.go:169-189)."""
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Batch insert (the reference inserts one at a time).

        Returns the node IDs (auto-assigned when `ids` is None).
        """
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
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            self._store.add_batch(id_arr, prepped)
        return id_arr.tolist()

    def remove(self, node_id: int) -> None:
        """Soft delete; excluded from search until Flush hard-deletes."""
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        """Hard-delete soft-deleted rows and compact (flat_index.go:266-299)."""
        with self._lock:
            self._store.flush()

    # -- search ---------------------------------------------------------------

    def _device_arrays(self):
        if self._storage == "float32":
            return self._store.device_state()
        if self._dev_cast_version != self._store.version:
            if self._storage == "int8":
                # quantize host-side from the f32 canonical copy; only the
                # int8 rows (+ dequant-domain sqnorms) ever reach the device
                store = self._store
                n = store.n
                scale = self._int8_scale
                if scale is None:
                    amax = (
                        float(np.abs(store.vectors[:n][store.valid[:n]]).max())
                        if store.valid[:n].any() else 0.0
                    )
                    scale = np.float32(max(amax, 1e-30) / 127.0)
                q = np.clip(
                    np.rint(store.vectors / scale), -127, 127
                ).astype(np.int8)
                deq = q.astype(np.float32) * scale
                sqn = np.einsum("nd,nd->n", deq, deq).astype(np.float32)
                self._dev_scale = jnp.asarray(scale)
                self._dev_cast = (
                    jnp.asarray(q), jnp.asarray(sqn), jnp.asarray(store.valid)
                )
            else:
                vecs32, sqnorms, valid = self._store.device_state()
                dtype = (
                    jnp.bfloat16 if self._storage == "bfloat16" else jnp.float16
                )
                self._dev_cast = (vecs32.astype(dtype), sqnorms, valid)
            self._dev_cast_version = self._store.version
        return self._dev_cast

    def _search_batch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        return self._search_collect(self._search_launch(queries, builder))

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        store = self._store
        n_slots = store.n  # includes soft-deleted rows, like len(index.vectors)
        if n_slots == 0:
            return ("empty", queries.shape[0])

        k_eff = sanitize_k(builder._k, n_slots)
        rerank = self._rerank and self._storage != "float32"
        k_want = min(k_eff * self._rerank_factor, n_slots) if rerank else k_eff
        k_pad = min(next_pow2(k_want), store.capacity)
        super_tile = min(store.capacity, DEFAULT_TILE * 8)

        qprep = preprocess(queries, self._distance_kind)
        qpad, q_real = pad_queries(qprep)

        vecs, sqnorms, valid = self._device_arrays()
        doc_filter = DocumentFilter(builder._document_ids)
        thr = threshold_scalar(builder._threshold)

        fmask = doc_filter.slot_mask(store.ids)
        if fmask is not None:
            valid = jnp.logical_and(valid, jnp.asarray(fmask))
        scale = self._dev_scale if self._storage == "int8" else None
        chunks = []
        for q0 in range(0, qpad.shape[0], QUERY_CHUNK):
            qc = upload_f32_exact(qpad[q0 : q0 + QUERY_CHUNK])
            chunks.append(
                block_topk(
                    qc, vecs, sqnorms, valid, thr,
                    k_pad, self._distance_kind, super_tile=super_tile,
                    scale=scale,
                )
            )
        handle = ("dev_chunks", chunks, q_real, k_want if rerank else k_eff,
                  store.ids)
        if rerank:
            return ("rerank", handle, qprep, k_eff, builder._threshold)
        return handle

    def _search_collect(self, handle):
        from comet_tpu.indexes.base import collect_device_handle

        if handle[0] != "rerank":
            return collect_device_handle(handle)
        return self._collect_rerank(*handle[1:])

    def _collect_rerank(self, inner, qprep, k_eff, threshold):
        """Exact-f32 refinement of a lossy-storage scan's candidates.

        The scan over-fetched rerank_factor*k candidates per query in the
        quantized/reduced distance domain; recompute their TRUE distances from
        the host-canonical float32 originals (tiny [Q, kc, d] einsum), re-apply
        the metric-space threshold, and keep the deterministic (score,
        slot)-ascending top k_eff. The device never holds the f32 corpus.
        """
        import jax

        from comet_tpu.indexes.base import collect_device_handle

        if inner[0] == "empty":
            return collect_device_handle(inner)
        _, chunks, q_real, kc, ids_snap = inner
        chunks = jax.device_get(chunks)
        scores = np.concatenate([a for a, _ in chunks])[:q_real]
        slots = np.concatenate([b for _, b in chunks])[:q_real]
        slots = slots[:, :kc].astype(np.int64)
        hit = slots != int(IDX_SENTINEL)
        safe = np.where(hit, slots, 0)
        vecs = self._store.vectors[safe]                 # [Q, kc, d]
        q = qprep[:q_real]
        ip = np.einsum("qd,qcd->qc", q, vecs, optimize=True)
        if self._distance_kind == DistanceKind.COSINE:
            exact = 1.0 - np.clip(ip, -1.0, 1.0)
        else:
            xn = np.einsum("qcd,qcd->qc", vecs, vecs, optimize=True)
            qn = np.einsum("qd,qd->q", q, q)[:, None]
            exact = np.maximum(qn + xn - 2.0 * ip, 0.0)
            if self._distance_kind == DistanceKind.L2:
                exact = np.sqrt(exact)
        thr = threshold_scalar(threshold)
        exact = np.where(hit & (exact <= thr), exact, np.inf).astype(np.float32)
        slots = np.where(np.isfinite(exact), slots, int(IDX_SENTINEL))
        slot_key = np.where(
            slots == int(IDX_SENTINEL), np.iinfo(np.int64).max, slots
        )
        order = np.lexsort((slot_key, exact), axis=1)[:, :k_eff]
        exact = np.take_along_axis(exact, order, axis=1)
        slots = np.take_along_axis(slots, order, axis=1)
        hit = slots != int(IDX_SENTINEL)
        ids = np.where(hit, ids_snap[np.where(hit, slots, 0)], INVALID_ID)
        return ids.astype(np.uint32), exact

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """Serialize; flushes soft deletes first like the reference
        (flat_index.go:366-369). Format: CFLT v1 header + params + arrays."""
        with self._lock:
            self._store.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            n = self._store.n
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            serial.write_array(w, self._store.vectors[:n])
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        """Deserialize into this index; stored params must match the
        receiving index's params (parity: flat_index.go ReadFrom validation)."""
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        if kind != self._distance_kind:
            raise serial.SerializationError(
                f"distance kind mismatch: index={self._distance_kind.value}, stored={kind.value}"
            )
        if dim != self._dim:
            raise serial.SerializationError(
                f"dimension mismatch: index={self._dim}, stored={dim}"
            )
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        vectors = serial.read_array(r)
        if version >= 2:
            r.verify()
        if len(ids) != n or vectors.shape != (n, dim):
            raise serial.SerializationError("corrupt flat index payload")
        with self._lock:
            self._store = type(self._store)(dim, capacity=max(n, 1))
            if n:
                self._store.add_batch(ids.astype(np.uint32), vectors.astype(np.float32))
