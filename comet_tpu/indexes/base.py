"""Shared machinery for array-backed vector indexes.

The reference keeps per-index Go slices/maps guarded by RWMutex with roaring
soft-delete bitmaps (flat_index.go:65-94 et al.). The array equivalent
is a padded slot store: host-canonical numpy arrays with power-of-two
capacity, a boolean validity mask (soft delete = clear a bit), and a lazily
synced device mirror (vectors + squared norms + valid mask in device
memory).

Every index exposes the same fluent search builder the reference does
(index_search.go:141-279): `.with_query(q).with_k(10).execute()`.
"""

from __future__ import annotations

import threading
from typing import Iterable, Sequence

import jax.numpy as jnp
import numpy as np

from comet_tpu.core.aggregation import aggregate_scores
from comet_tpu.core.limiter import autocut_results, limit_results
from comet_tpu.core.node import VectorNode
from comet_tpu.core.results import Reranker, VectorResult
from comet_tpu.utils.memory import memory_report
from comet_tpu.types import (
    DimensionMismatchError,
    DistanceKind,
    InvalidConfigError,
    NodeNotFoundError,
    ScoreAggregationKind,
)

MIN_CAPACITY = 1024


def next_pow2(x: int, minimum: int = 1) -> int:
    v = max(int(x), minimum)
    return 1 << (v - 1).bit_length()


def narrow_wire(vecs_np: np.ndarray) -> np.ndarray:
    """Narrow EXACT transfer format for a float32 matrix, when one exists.

    The classic vector-search corpora are integer-valued (SIFT descriptors are
    0..255 gradient counts — siftgen reproduces this), so a f32 corpus whose
    values are all integers in uint8/int8/int16 range moves to the device at
    1/4 or 1/2 the bytes and casts back to f32 there BIT-EXACTLY (integers up
    to 2^15 are exact in f32). Non-integral corpora (e.g. cosine-normalized)
    keep f32. The integrality check runs on a 4096-row sample first so float
    corpora pay ~nothing. Returns the narrow array, or `vecs_np` unchanged."""
    n = vecs_np.shape[0]
    if n and vecs_np.dtype == np.float32:
        sample = vecs_np[: min(n, 4096)]
        if np.array_equal(np.rint(sample), sample) and np.array_equal(
            np.rint(vecs_np), vecs_np
        ):
            amin = float(vecs_np.min()) if vecs_np.size else 0.0
            amax = float(vecs_np.max()) if vecs_np.size else 0.0
            wire_dtype = (
                np.uint8 if 0.0 <= amin and amax <= 255.0   # SIFT bytes
                else np.int8 if -128.0 <= amin and amax <= 127.0
                else np.int16 if -32768.0 <= amin and amax <= 32767.0
                else None
            )
            if wire_dtype is not None:
                return vecs_np.astype(wire_dtype)
    return vecs_np


_CAST_F32 = None


def upload_f32_exact(vecs_np: np.ndarray) -> jnp.ndarray:
    """Upload a float32 matrix to the device via the narrowest exact
    transfer format (see `narrow_wire`), casting back to f32 on device.

    The cast jit is a MODULE-LEVEL singleton: a fresh `jax.jit(lambda...)`
    per call would re-trace on every invocation."""
    global _CAST_F32
    import jax

    wire = narrow_wire(vecs_np)
    if wire.dtype == np.float32:
        return jnp.asarray(wire)
    if _CAST_F32 is None:
        _CAST_F32 = jax.jit(lambda w: w.astype(jnp.float32))
    return _CAST_F32(jnp.asarray(wire))


class SlotStore:
    """Padded host-canonical vector storage with soft deletes.

    Slots [0, n) are occupied (possibly soft-deleted); [n, capacity) are free
    padding. `valid[slot]` False means deleted-or-padding. Device mirrors are
    rebuilt only when `version` changes.
    """

    def __init__(self, dim: int, capacity: int = MIN_CAPACITY):
        self.dim = dim
        self.capacity = next_pow2(capacity, MIN_CAPACITY)
        self.vectors = np.zeros((self.capacity, dim), dtype=np.float32)
        self.ids = np.zeros(self.capacity, dtype=np.uint32)
        self.valid = np.zeros(self.capacity, dtype=bool)
        self.n = 0
        self.id_to_slot: dict[int, int] = {}
        self.deleted = 0
        self.version = 0
        self._dev_version = -1
        self._dev = None  # (vectors, sqnorms, valid) jnp arrays

    # -- mutation ----------------------------------------------------------

    def _grow_to(self, needed: int) -> None:
        new_cap = next_pow2(needed, MIN_CAPACITY)
        if new_cap <= self.capacity:
            return
        vectors = np.zeros((new_cap, self.dim), dtype=np.float32)
        vectors[: self.n] = self.vectors[: self.n]
        ids = np.zeros(new_cap, dtype=np.uint32)
        ids[: self.n] = self.ids[: self.n]
        valid = np.zeros(new_cap, dtype=bool)
        valid[: self.n] = self.valid[: self.n]
        self.vectors, self.ids, self.valid = vectors, ids, valid
        self.capacity = new_cap

    def add_batch(self, ids: np.ndarray, vectors: np.ndarray) -> np.ndarray:
        """Append preprocessed vectors; returns the assigned slots."""
        b = len(ids)
        if b > 1 and len(np.unique(ids)) != b:
            # callers check ids against the store; an intra-batch duplicate
            # would otherwise corrupt id_to_slot (two live slots, one id)
            raise InvalidConfigError("duplicate node IDs within batch")
        self._grow_to(self.n + b)
        slots = np.arange(self.n, self.n + b)
        self.vectors[slots] = vectors
        self.ids[slots] = ids
        self.valid[slots] = True
        for i, s in zip(ids.tolist(), slots.tolist()):
            self.id_to_slot[i] = s
        self.n += b
        self.version += 1
        return slots

    def remove(self, node_id: int) -> None:
        """Soft delete (reference: roaring deletedNodes bitmap, flat_index.go:89)."""
        slot = self.id_to_slot.pop(int(node_id), None)
        if slot is None:
            raise NodeNotFoundError(f"node ID {node_id} not found in index")
        self.valid[slot] = False
        self.deleted += 1
        self.version += 1

    def flush(self) -> np.ndarray:
        """Hard-delete: compact live slots to the front (flat_index.go:266-299).

        Returns the permutation of old slots kept (for subclasses that track
        slot-indexed side arrays).
        """
        keep = np.flatnonzero(self.valid[: self.n])
        m = len(keep)
        self.vectors[:m] = self.vectors[keep]
        self.vectors[m : self.n] = 0.0
        self.ids[:m] = self.ids[keep]
        self.ids[m : self.n] = 0
        self.valid[:m] = True
        self.valid[m : self.n] = False
        self.n = m
        self.deleted = 0
        self.id_to_slot = {int(i): s for s, i in enumerate(self.ids[:m].tolist())}
        self.version += 1
        return keep

    # -- queries -----------------------------------------------------------

    def contains(self, node_id: int) -> bool:
        return int(node_id) in self.id_to_slot

    def get_vector(self, node_id: int) -> np.ndarray:
        slot = self.id_to_slot.get(int(node_id))
        if slot is None:
            raise NodeNotFoundError(f"node ID {node_id} not found in index")
        return self.vectors[slot]

    @property
    def live_count(self) -> int:
        return self.n - self.deleted

    def device_state(self):
        """Lazily synced device mirror: (vectors, sqnorms, valid) in HBM."""
        if self._dev_version != self.version:
            vecs = upload_f32_exact(self.vectors)
            sqnorms = jnp.sum(vecs * vecs, axis=1)
            valid = jnp.asarray(self.valid)
            self._dev = (vecs, sqnorms, valid)
            self._dev_version = self.version
        return self._dev


class VectorSearchBuilder:
    """Fluent search builder shared by all vector indexes
    (reference: index_search.go:141-279)."""

    def __init__(self, index):
        self._index = index
        self._queries: list[np.ndarray] = []
        self._node_ids: list[int] = []
        self._k = 10
        self._threshold = 0.0
        self._cutoff = -1
        self._aggregation = ScoreAggregationKind.SUM
        self._document_ids: list[int] | None = None
        self._reranker: Reranker | None = None
        # per-index knobs; validated by the index that consumes them
        self._nprobes: int | None = None
        self._ef_search: int | None = None
        self._nrefine: int | None = None
        # batch API: False drops scores from the result contract (ids only)
        self._wire_scores = True

    # builder knobs --------------------------------------------------------

    def with_query(self, query) -> "VectorSearchBuilder":
        self._queries.append(np.asarray(query, dtype=np.float32))
        return self

    def with_queries(self, queries) -> "VectorSearchBuilder":
        for q in queries:
            self.with_query(q)
        return self

    def with_node(self, node_id: int) -> "VectorSearchBuilder":
        self._node_ids.append(int(node_id))
        return self

    def with_nodes(self, node_ids: Iterable[int]) -> "VectorSearchBuilder":
        self._node_ids.extend(int(i) for i in node_ids)
        return self

    def with_k(self, k: int) -> "VectorSearchBuilder":
        self._k = int(k)
        return self

    def with_threshold(self, threshold: float) -> "VectorSearchBuilder":
        self._threshold = float(threshold)
        return self

    def with_cutoff(self, cutoff: int) -> "VectorSearchBuilder":
        self._cutoff = int(cutoff)
        return self

    def with_score_aggregation(self, kind: ScoreAggregationKind) -> "VectorSearchBuilder":
        self._aggregation = ScoreAggregationKind(kind)
        return self

    def with_document_ids(self, document_ids) -> "VectorSearchBuilder":
        """Accepts an iterable of IDs or a packed Bitset (stays packed)."""
        from comet_tpu.ops.bitset import Bitset

        if isinstance(document_ids, Bitset):
            self._document_ids = document_ids
        else:
            self._document_ids = [int(i) for i in document_ids]
        return self

    def with_reranker(self, reranker: Reranker) -> "VectorSearchBuilder":
        self._reranker = reranker
        return self

    def with_nprobes(self, nprobes: int) -> "VectorSearchBuilder":
        self._nprobes = int(nprobes)
        return self

    def with_ef_search(self, ef_search: int) -> "VectorSearchBuilder":
        self._ef_search = int(ef_search)
        return self

    def with_nrefine(self, nrefine: int) -> "VectorSearchBuilder":
        """Exact re-ranking of the top `nrefine` ADC candidates (IVFPQ with
        store_originals=True). The reference README promises this knob but
        its Go code never implements it (README.md:1779, SURVEY.md §7)."""
        self._nrefine = int(nrefine)
        return self

    # execution ------------------------------------------------------------

    def execute(self) -> list[VectorResult]:
        return self._index._execute_search(self)


class BaseVectorIndex:
    """Common behavior for flat/IVF/PQ/IVFPQ: node-based queries, the
    aggregate → limit → autocut → rerank pipeline (flat_index_search.go:109-165),
    and the soft-delete/add bookkeeping."""

    def __init__(self, dim: int, distance_kind: DistanceKind):
        if dim <= 0:
            raise InvalidConfigError(f"dimension must be positive, got {dim}")
        self._dim = dim
        self._distance_kind = DistanceKind(distance_kind)
        self._store = SlotStore(dim)
        self._lock = threading.RLock()

    # -- contracts (index.go:32-63) -----------------------------------------

    def dimensions(self) -> int:
        return self._dim

    def distance_kind(self) -> DistanceKind:
        return self._distance_kind

    def trained(self) -> bool:
        return True

    def count(self) -> int:
        """Live (non-deleted) vector count."""
        with self._lock:
            return self._store.live_count

    def stats(self) -> dict:
        """Observability snapshot (the reference exposes nothing comparable;
        SURVEY.md §5.1)."""
        with self._lock:
            s = self._store
            return {
                "kind": self.kind().value,
                "dim": self._dim,
                "distance": self._distance_kind.value,
                "live": s.live_count,
                "soft_deleted": s.deleted,
                "capacity": s.capacity,
                "host_bytes": int(s.vectors.nbytes + s.ids.nbytes + s.valid.nbytes),
                "device_synced": s._dev_version == s.version,
                # exact per-structure memory (utils/memory.py; the
                # reference only publishes narrative numbers,
                # docs/INDEX.md:1977-1990)
                "memory": memory_report(self),
            }

    def new_search(self) -> VectorSearchBuilder:
        return VectorSearchBuilder(self)

    def search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        threshold: float = 0.0,
        document_ids: Iterable[int] | None = None,
        nprobes: int | None = None,
        ef_search: int | None = None,
        nrefine: int | None = None,
        aggregation=None,
        cutoff: int = -1,
        group_size: int = 1,
        wire_scores: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Throughput API: many independent queries in one step.

        Unlike the fluent builder (where multiple queries are AGGREGATED into
        one result list, flat_index_search.go:144-153), each row here is its
        own query. Returns (ids [Q, k] uint32, scores [Q, k] float32); empty
        slots carry id == INVALID_ID and score == +inf. The reference has no
        equivalent — it searches one query at a time.

        The fluent pipeline's post-steps are available per row so the two
        APIs share one semantics surface (VERDICT r3 #6): `cutoff` applies
        the autocut algorithm (limiter.go:81-118) to each output row;
        `group_size` > 1 aggregates each consecutive group of rows into ONE
        output row with `aggregation` (Sum default — the fluent multi-query
        semantics, aggregation.go:72-83), so the output has
        Q / group_size rows.
        """
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        self._check_dim(queries)
        builder = self._make_batch_builder(
            k, threshold, document_ids, nprobes, ef_search, nrefine,
            wire_scores=wire_scores,
        )
        if not wire_scores and (cutoff != -1 or group_size > 1):
            raise InvalidConfigError(
                "wire_scores=False cannot combine with cutoff/aggregation "
                "post-steps (they need the scores on host)"
            )
        with self._lock:
            ids, scores = self._search_batch(queries, builder)
        if ids.shape[1] > k:
            ids, scores = ids[:, :k], scores[:, :k]
        return postprocess_batch_rows(
            ids, scores, k,
            aggregation=aggregation, cutoff=cutoff, group_size=group_size,
            ascending=True,
        )

    def search_stream(
        self,
        batches: Iterable[np.ndarray],
        k: int = 10,
        *,
        threshold: float = 0.0,
        document_ids: Iterable[int] | None = None,
        nprobes: int | None = None,
        ef_search: int | None = None,
        nrefine: int | None = None,
        depth: int = 2,
        aggregation=None,
        cutoff: int = -1,
        group_size: int = 1,
        wire_scores: bool = True,
    ):
        """Pipelined bulk search: yields (ids, scores) per input batch.

        Keeps up to `depth` batches in flight so device compute of batch
        i+1 overlaps the result download of batch i. Results reflect the
        index state at submission time. Semantics per batch are identical
        to `search_batch` (aggregation groups never span input batches).
        """
        # validate EAGERLY (this wrapper is not a generator, so bad knob
        # combinations raise at the call site, not at first iteration)
        builder = self._make_batch_builder(
            k, threshold, document_ids, nprobes, ef_search, nrefine,
            wire_scores=wire_scores,
        )
        if not wire_scores and (cutoff != -1 or group_size > 1):
            raise InvalidConfigError(
                "wire_scores=False cannot combine with cutoff/aggregation "
                "post-steps (they need the scores on host)"
            )
        return self._search_stream_iter(
            batches, builder, k, depth, aggregation, cutoff, group_size
        )

    def _search_stream_iter(
        self, batches, builder, k, depth, aggregation, cutoff, group_size
    ):
        from collections import deque

        pending: deque = deque()

        def collect():
            ids, scores = self._search_collect(pending.popleft())
            if ids.shape[1] > k:
                ids, scores = ids[:, :k], scores[:, :k]
            return postprocess_batch_rows(
                ids, scores, k,
                aggregation=aggregation, cutoff=cutoff,
                group_size=group_size, ascending=True,
            )

        for queries in batches:
            queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
            self._check_dim(queries)
            with self._lock:
                pending.append(self._search_launch(queries, builder))
            if len(pending) >= depth:
                yield collect()
        while pending:
            yield collect()

    def _make_batch_builder(
        self, k, threshold, document_ids, nprobes, ef_search, nrefine=None,
        wire_scores=True,
    ) -> "VectorSearchBuilder":
        from comet_tpu.ops.bitset import Bitset

        builder = VectorSearchBuilder(self)
        builder._wire_scores = bool(wire_scores)
        builder._k = int(k)
        builder._threshold = float(threshold)
        if document_ids is None or isinstance(document_ids, Bitset):
            builder._document_ids = document_ids  # bitsets stay packed
        else:
            builder._document_ids = [int(i) for i in document_ids]
        builder._nprobes = nprobes
        builder._ef_search = ef_search
        builder._nrefine = nrefine
        return builder

    def _search_launch(self, queries: np.ndarray, builder: "VectorSearchBuilder"):
        """Submit one batch; returns an opaque handle for _search_collect.
        Default: compute synchronously (subclasses with device pipelines
        override to return in-flight device arrays)."""
        return self._search_batch(queries, builder)

    def _search_collect(self, handle):
        return handle

    # -- helpers -------------------------------------------------------------

    def _check_dim(self, vectors: np.ndarray) -> None:
        if vectors.shape[-1] != self._dim:
            raise DimensionMismatchError(
                f"vector dimension mismatch: expected {self._dim}, got {vectors.shape[-1]}"
            )

    def _lookup_node_vectors(self, node_ids: Sequence[int]) -> list[np.ndarray]:
        """WithNode resolution (flat_index_search.go:171-196)."""
        out = []
        for node_id in node_ids:
            out.append(np.array(self._store.get_vector(node_id)))
        return out

    def _execute_search(self, builder: VectorSearchBuilder) -> list[VectorResult]:
        state = self._execute_launch(builder)
        return self._execute_collect(builder, state)

    def _execute_launch(self, builder: VectorSearchBuilder):
        """Validate + submit the fluent search; the returned opaque state
        may hold in-flight device arrays (collect with _execute_collect).
        Lets callers (the hybrid coordinator) overlap the device round-trip
        with host-side work — the reference runs its hybrid steps strictly
        sequentially (hybrid_search_index.go:477-615)."""
        if not builder._queries and not builder._node_ids:
            raise InvalidConfigError("must specify either queries or node IDs")

        with self._lock:
            queries = list(builder._queries)
            for q in queries:
                self._check_dim(q)
            if builder._node_ids:
                queries.extend(self._lookup_node_vectors(builder._node_ids))
            if not queries:
                return None
            qarr = np.stack(queries).astype(np.float32)
            return self._search_launch(qarr, builder)

    def _execute_collect(
        self, builder: VectorSearchBuilder, state
    ) -> list[VectorResult]:
        if state is None:
            return []
        # Index-specific batched search: [Q, k_eff] ids/scores with
        # id == INVALID_ID marking empty slots.
        ids, scores = self._search_collect(state)

        flat_ids = ids.reshape(-1)
        flat_scores = scores.reshape(-1)
        keep = flat_ids != INVALID_ID
        flat_ids = flat_ids[keep]
        flat_scores = flat_scores[keep]

        uids, uscores = aggregate_scores(
            flat_ids, flat_scores, builder._aggregation, ascending=True
        )
        results = [
            VectorResult(node=self._result_node(int(i)), score=float(s))
            for i, s in zip(uids, uscores)
        ]
        results = limit_results(results, builder._k)
        results = autocut_results(results, builder._cutoff)
        if builder._reranker is not None:
            results = builder._reranker.rerank(results)
        return results

    def _result_node(self, node_id: int) -> VectorNode:
        """Node materialization for results; PQ overrides (no originals)."""
        return VectorNode(node_id, np.array(self._store.get_vector(node_id)))

    # subclasses implement:
    def _search_batch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        raise NotImplementedError


INVALID_ID = np.uint32(0xFFFFFFFF)


def postprocess_batch_rows(
    ids: np.ndarray,
    scores: np.ndarray,
    k: int,
    *,
    aggregation=None,
    cutoff: int = -1,
    group_size: int = 1,
    ascending: bool = True,
    empty_score: float = np.inf,
) -> tuple[np.ndarray, np.ndarray]:
    """Fluent-pipeline post-steps for batched [Q, k] id/score rows.

    `group_size` > 1: each consecutive group of rows aggregates (dedup by
    id with Sum/Max/Mean, aggregation.go:72-83) into one output row, sorted
    by (score, id) in `ascending` direction — exactly the fluent
    multi-query semantics per group. `cutoff` != -1 then applies autocut
    (limiter.go:81-118) per output row: slots past the cut are cleared to
    (INVALID_ID, `empty_score`). No-op (and copy-free) when neither knob is
    set.
    """
    from comet_tpu.core.aggregation import aggregate_scores
    from comet_tpu.core.limiter import autocut
    from comet_tpu.types import ScoreAggregationKind

    if group_size > 1:
        q = ids.shape[0]
        if q % group_size:
            raise InvalidConfigError(
                f"query count {q} not divisible by group_size {group_size}"
            )
        agg = (
            ScoreAggregationKind(aggregation)
            if aggregation is not None
            else ScoreAggregationKind.SUM
        )
        g = q // group_size
        out_ids = np.full((g, k), INVALID_ID, dtype=np.uint32)
        out_scores = np.full((g, k), empty_score, dtype=np.float32)
        grp_i = ids.reshape(g, -1)
        grp_s = scores.reshape(g, -1)
        for gi in range(g):
            keep = grp_i[gi] != INVALID_ID
            uids, uscores = aggregate_scores(
                grp_i[gi][keep], grp_s[gi][keep], agg, ascending=ascending
            )
            m = min(k, len(uids))
            out_ids[gi, :m] = uids[:m]
            out_scores[gi, :m] = uscores[:m]
        ids, scores = out_ids, out_scores
    if cutoff != -1:
        ids = ids.copy() if group_size <= 1 else ids
        scores = scores.copy() if group_size <= 1 else scores
        for r in range(ids.shape[0]):
            nv = int((ids[r] != INVALID_ID).sum())
            cut = autocut(scores[r][:nv], cutoff) if nv else 0
            ids[r, cut:] = INVALID_ID
            scores[r, cut:] = empty_score
    return ids, scores


def collect_device_handle(handle):
    """Materialize a _search_launch handle into (ids, scores) numpy arrays.

    Handle forms (shared by the vector indexes):
      ("empty", q)                         — no rows in the index
      ("dev_chunks", chunks, q_real, k_eff, ids) — per-chunk device pairs
    """
    import jax

    from comet_tpu.ops.topk import IDX_SENTINEL

    kind = handle[0]
    if kind == "empty":
        q = handle[1]
        return (
            np.full((q, 0), INVALID_ID, dtype=np.uint32),
            np.zeros((q, 0), dtype=np.float32),
        )
    _, chunks, q_real, k_eff, ids_snap = handle
    chunks = jax.device_get(chunks)
    scores = np.concatenate([s for s, _ in chunks])[:q_real, :k_eff]
    slots_np = np.concatenate([i for _, i in chunks])[:q_real, :k_eff]

    hit = slots_np != int(IDX_SENTINEL)
    ids = np.where(hit, ids_snap[np.where(hit, slots_np, 0)], INVALID_ID)
    return ids.astype(np.uint32), scores


def pad_queries(qarr: np.ndarray) -> tuple[np.ndarray, int]:
    """Pad the query batch to a power-of-two row count (compile bucketing)."""
    q = qarr.shape[0]
    qp = next_pow2(q)
    if qp == q:
        return qarr, q
    out = np.zeros((qp, qarr.shape[1]), dtype=np.float32)
    out[:q] = qarr
    return out, q


def threshold_scalar(threshold: float) -> np.float32:
    """Reference semantics: threshold <= 0 means disabled
    (flat_index_search.go:269). Returns a HOST scalar: jitted search
    dispatches ship it with their arguments, where an eager jnp.asarray
    here would cost a separate device_put enqueue on every query."""
    return np.float32(threshold) if threshold > 0 else np.float32(np.inf)
