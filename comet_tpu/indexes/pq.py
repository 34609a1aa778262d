"""PQ (product quantization) vector index.

Capability parity with the reference's PQIndex (pq_index.go,
pq_index_search.go): M subspaces x 2^Nbits centroids trained per subspace,
originals discarded after encoding (pq_index.go:249-262), ADC search with a
per-query LUT of squared subspace distances and sqrt'd sums
(pq_index_search.go:243-306), soft delete + flush, thresholds / filters /
aggregation / autocut / rerankers, binary serialization, and the
`calculate_pq_params` helper (pq_index.go:50-67).

Design: training vmaps k-means per subspace, encoding is a batched
einsum+argmin, and ADC is a one-hot [Q, M*Ksub] x [M*Ksub, T] matmul per
corpus tile with exact block-select top-k (ops/adc.py). Codes are uint8 on
device when Ksub <= 256 (cast to int32 for the one-hot), uint8/uint16 on
disk.

Node-based queries and result nodes use the DECODED (reconstructed)
vectors — the index no longer has the originals, by design.
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
    SlotStore,
    VectorSearchBuilder,
    next_pow2,
    pad_queries,
    threshold_scalar,
)
from comet_tpu.io import serial
from comet_tpu.ops.adc import adc_topk, build_lut, pq_decode, pq_encode
from comet_tpu.ops.distance import preprocess
from comet_tpu.ops.kmeans import kmeans_subspace
from comet_tpu.types import (
    DistanceKind,
    InvalidConfigError,
    NodeNotFoundError,
    NotTrainedError,
    VectorIndexKind,
)

MAGIC = b"CPQX"
VERSION = 3  # v3: optional OPQ rotation; v2: CRC32 trailer (older readable)

PQ_QUERY_CHUNK = 256


def calculate_pq_params(dim: int) -> tuple[int, int]:
    """Recommended (M, Nbits) for a dimension (pq_index.go:50-67)."""
    m = 8
    if dim % m != 0:
        for m in range(8, 33):
            if dim % m == 0:
                break
        if dim % m != 0:
            m = 4
    return m, 8


class PQIndex(BaseVectorIndex):
    """Product-quantization index (reference: pq_index.go:75-120)."""

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        m: int | None = None,
        nbits: int = 8,
        opq: bool = False,
        opq_iters: int = 6,
    ):
        super().__init__(dim, distance_kind)
        if m is None:
            m, nbits = calculate_pq_params(dim)
        if m <= 0:
            raise InvalidConfigError("parameter M must be positive")
        if dim % m != 0:
            raise InvalidConfigError(f"dimension {dim} must be divisible by M {m}")
        if nbits <= 0 or nbits > 16:
            raise InvalidConfigError("parameter Nbits must be in [1,16]")
        self._m = m
        self._nbits = nbits
        self._ksub = 1 << nbits
        self._dsub = dim // m
        # OPQ extension (same design as IVFPQIndex: the model lives in
        # rotated coordinates, serving stays in user coordinates — queries
        # rotate into model space before the LUT is built).
        self._opq = bool(opq)
        self._opq_iters = int(opq_iters)
        self._rot: np.ndarray | None = None
        # Vector-less slot store: PQ keeps codes, not originals.
        self._store = SlotStore(0)
        self._codes = np.zeros((self._store.capacity, m), dtype=np.int32)
        self._codebooks: np.ndarray | None = None  # [M, Ksub, dsub]
        self._trained = False
        self._dev_version = -1
        self._dev_codes = None
        self._dev_codebooks = None

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.PQ

    def trained(self) -> bool:
        return self._trained

    @property
    def m(self) -> int:
        return self._m

    @property
    def nbits(self) -> int:
        return self._nbits

    @property
    def ksub(self) -> int:
        return self._ksub

    # -- training --------------------------------------------------------------

    def train(self, vectors: np.ndarray, max_iter: int = 20) -> None:
        """Learn per-subspace codebooks (pq_index.go:74-127): k-means with
        L2^2 in each of the M subspaces; needs >= Ksub training vectors."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if len(vectors) < self._ksub:
            raise InvalidConfigError(
                f"need at least {self._ksub} vectors for training"
            )
        prepped = preprocess(vectors, self._distance_kind)
        rot = self._train_opq(prepped, max_iter) if self._opq else None
        if rot is not None:
            prepped = prepped @ rot
        sub = prepped.reshape(len(prepped), self._m, self._dsub)
        codebooks, _ = kmeans_subspace(sub, self._ksub, max_iter, return_assign=False)
        with self._lock:
            self._rot = rot
            self._codebooks = codebooks
            self._trained = True
            # Re-encode any existing vectors? Originals are gone — the
            # reference has the same limitation; retraining with content is
            # only valid on an empty index.
            self._dev_version = -1

    def _train_opq(self, prepped: np.ndarray, max_iter: int) -> np.ndarray:
        """OPQ-NP alternation (see IVFPQIndex._train_opq; here the model
        is codebooks only — no coarse stage). Device fits + host d x d SVD."""
        import jax

        from comet_tpu.ops.distance import DEFAULT_PRECISION

        d = self._dim
        y_dev = jnp.asarray(prepped)
        rot = np.eye(d, dtype=np.float32)

        @jax.jit
        def rotate(y, r):
            return jnp.dot(y, r, preferred_element_type=jnp.float32,
                           precision=DEFAULT_PRECISION)

        @jax.jit
        def chunk_m(y_chunk, z_chunk, books):
            # chunked encode+reconstruct+partial-M: whole-set pq_encode
            # materializes [n, M, Ksub] f32 (code review r5)
            codes = pq_encode(
                z_chunk.reshape(z_chunk.shape[0], self._m, self._dsub),
                books,
            )
            rec = pq_decode(codes, books)
            return jnp.dot(y_chunk.T, rec, preferred_element_type=jnp.float32,
                           precision=DEFAULT_PRECISION)

        inner_iter = max(2, min(4, max_iter))
        chunk = 1 << 17
        n = len(prepped)
        for _ in range(max(self._opq_iters, 1)):
            z = np.asarray(rotate(y_dev, jnp.asarray(rot)))
            books, _ = kmeans_subspace(
                z.reshape(len(z), self._m, self._dsub), self._ksub,
                inner_iter, return_assign=False,
            )
            books_d = jnp.asarray(books)
            mm = np.zeros((d, d), np.float64)
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                mm += np.asarray(chunk_m(
                    y_dev[lo:hi], jnp.asarray(z[lo:hi]), books_d
                ), dtype=np.float64)
            u, _, vt = np.linalg.svd(mm)
            rot = (u @ vt).astype(np.float32)
        return rot

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Encode to M codes per vector and discard originals
        (pq_index.go:249-262)."""
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
        # Streamed chunked encode: all chunks dispatched before any result
        # is collected, so uploads overlap device compute (ops/adc.py).
        from comet_tpu.ops.adc import stream_device_map

        from comet_tpu.indexes.base import narrow_wire

        cb_dev = jnp.asarray(self._codebooks)
        rot_dev = jnp.asarray(self._rot) if self._rot is not None else None
        m = self._m

        def encode_chunk(chunk):
            if chunk.dtype != jnp.float32:
                chunk = chunk.astype(jnp.float32)  # exact narrow-wire cast
            if rot_dev is not None:
                from comet_tpu.ops.distance import DEFAULT_PRECISION

                chunk = jnp.dot(chunk, rot_dev,
                                preferred_element_type=jnp.float32,
                                precision=DEFAULT_PRECISION)
            return pq_encode(chunk.reshape(chunk.shape[0], m, -1), cb_dev)

        codes = stream_device_map(
            encode_chunk, narrow_wire(prepped), chunk_rows=1 << 17
        )
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            slots = self._store.add_batch(
                id_arr, np.zeros((len(id_arr), 0), dtype=np.float32)
            )
            if self._store.capacity > len(self._codes):
                grown = np.zeros((self._store.capacity, self._m), dtype=np.int32)
                grown[: len(self._codes)] = self._codes
                self._codes = grown
            self._codes[slots] = codes
        return id_arr.tolist()

    def remove(self, node_id: int) -> None:
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        with self._lock:
            keep = self._store.flush()
            kept = self._codes[keep]
            self._codes[: len(kept)] = kept
            self._codes[len(kept):] = 0

    # -- search ---------------------------------------------------------------

    def _decode(self, codes: np.ndarray) -> np.ndarray:
        rec = np.asarray(
            pq_decode(jnp.asarray(codes), jnp.asarray(self._codebooks))
        )
        if self._rot is not None:
            rec = rec @ self._rot.T  # model space -> user space
        return rec

    def _lookup_node_vectors(self, node_ids):
        """WithNode queries run on DECODED vectors (originals discarded)."""
        out = []
        for node_id in node_ids:
            slot = self._store.id_to_slot.get(int(node_id))
            if slot is None:
                raise NodeNotFoundError(f"node ID {node_id} not found in index")
            out.append(self._decode(self._codes[slot][None, :])[0])
        return out

    def _result_node(self, node_id: int) -> VectorNode:
        slot = self._store.id_to_slot[int(node_id)]
        return VectorNode(node_id, self._decode(self._codes[slot][None, :])[0])

    def _device_codes(self):
        if self._dev_version != self._store.version:
            code_np = (
                self._codes.astype(np.uint8) if self._ksub <= 256
                else self._codes
            )  # narrow transfer and storage; consumers cast to i32
            self._dev_codes = jnp.asarray(code_np)
            self._dev_codebooks = jnp.asarray(self._codebooks)
            self._dev_version = self._store.version
        return self._dev_codes, self._dev_codebooks

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

        qprep = preprocess(queries, self._distance_kind)
        qpad, q_real = pad_queries(qprep)

        _, _, valid = store.device_state()
        doc_filter = DocumentFilter(builder._document_ids)
        fmask = doc_filter.slot_mask(store.ids)
        if fmask is not None:
            valid = jnp.logical_and(valid, jnp.asarray(fmask))
        thr = threshold_scalar(builder._threshold)

        codes_dev, codebooks_dev = self._device_codes()
        if self._rot is not None:
            qpad = qpad @ self._rot  # LUT path scores in model space
        chunks = []
        for q0 in range(0, qpad.shape[0], PQ_QUERY_CHUNK):
            qc = qpad[q0 : q0 + PQ_QUERY_CHUNK]
            lut = build_lut(
                jnp.asarray(qc.reshape(len(qc), self._m, self._dsub)),
                codebooks_dev,
            )
            chunks.append(adc_topk(lut, codes_dev, valid, thr, k_pad))
        return ("dev_chunks", chunks, q_real, k_eff, store.ids)

    def _search_collect(self, handle):
        from comet_tpu.indexes.base import collect_device_handle

        return collect_device_handle(handle)

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CPQX v1: params + codebooks + ids/codes (flushed)."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            serial.write_u32(w, self._m)
            serial.write_u32(w, self._nbits)
            serial.write_u32(w, 1 if self._trained else 0)
            serial.write_u32(w, 1 if self._rot is not None else 0)
            if self._rot is not None:
                serial.write_array(w, self._rot)
            if self._trained:
                serial.write_array(w, self._codebooks)
            n = self._store.n
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            code_dtype = np.uint8 if self._nbits <= 8 else np.uint32
            serial.write_array(w, self._codes[:n].astype(code_dtype))
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        m = serial.read_u32(r)
        nbits = serial.read_u32(r)
        if kind != self._distance_kind:
            raise serial.SerializationError(
                f"distance kind mismatch: index={self._distance_kind.value}, stored={kind.value}"
            )
        if dim != self._dim:
            raise serial.SerializationError(f"dimension mismatch: index={self._dim}, stored={dim}")
        if m != self._m or nbits != self._nbits:
            raise serial.SerializationError(
                f"PQ param mismatch: index=(M={self._m}, Nbits={self._nbits}), "
                f"stored=(M={m}, Nbits={nbits})"
            )
        trained = bool(serial.read_u32(r))
        rot = None
        if version >= 3 and serial.read_u32(r):
            rot = serial.read_array(r).astype(np.float32)
        codebooks = serial.read_array(r) if trained else None
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        codes = serial.read_array(r)
        if version >= 2:
            r.verify()
        if len(ids) != n or codes.shape != (n, m):
            raise serial.SerializationError("corrupt PQ index payload")
        with self._lock:
            self._rot = rot
            self._opq = rot is not None
            self._codebooks = codebooks
            self._trained = trained
            self._store = SlotStore(0, capacity=max(n, 1))
            self._codes = np.zeros((self._store.capacity, self._m), dtype=np.int32)
            if n:
                slots = self._store.add_batch(
                    ids.astype(np.uint32), np.zeros((n, 0), dtype=np.float32)
                )
                self._codes[slots] = codes.astype(np.int32)
            self._dev_version = -1
