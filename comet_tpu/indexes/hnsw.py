"""HNSW vector index as batched beam search.

Capability parity with the reference's HNSWIndex (hnsw_index.go,
hnsw_index_search.go): multi-layer navigable small-world graph with
geometric random levels p=1/M capped at 16 (hnsw_index.go:474-484), layer-0
degree 2M (:529-531), simple nearest-M neighbor selection (:637-656),
prune-to-capacity (:667-694), per-query efSearch override with
default-to-efConstruction-when-0 (:185-187, hnsw_index_search.go:271-306),
soft delete + flush with entry-point repair (:384-413), serialization.

Design (NOT a port of the pointer-chasing Go implementation):

- Layer 0 lives as a padded [cap, 2M] adjacency array in device memory;
  search is `ops.graph.beam_search_layer0` — a lockstep batched best-first
  beam where thousands of queries expand in parallel inside one XLA
  while_loop.
- The beam starts either from the nearest upper-layer member (one device
  matmul, `ops.graph.nearest_entry`) or, at n >= SEED_MIN_N, from the top
  candidates of an IVF probe scan over ~sqrt(n) k-means cells (the
  seeded beam, terminating on a k-window bound).
- Doc-ID filters / thresholds / soft-deletes gate RESULT admission inside
  the kernel while filtered nodes still route traversal — fixing the
  reference's post-filtering weakness (hnsw_index_search.go:308-335) where
  selective filters return < k results.
- Construction of an empty index from a large batch is the staged
  exact-kNN bulk build (ops/graph_build.py). Incremental construction is
  BATCHED: rounds of new nodes beam-search the existing graph on device
  for their efConstruction candidate sets (plus exact intra-round
  candidates), then connect/prune on host and scatter only the touched
  adjacency rows back to the device (ops.graph.scatter_graph_update,
  donated buffers). The reference inserts one node at a time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Iterable

import jax.numpy as jnp
import numpy as np

from comet_tpu.core.filter import DocumentFilter
from comet_tpu.core.limiter import sanitize_k
from comet_tpu.core.node import VectorNode, reserve_node_ids
from comet_tpu.indexes.base import (
    BaseVectorIndex,
    VectorSearchBuilder,
    collect_device_handle,
    next_pow2,
    pad_queries,
    threshold_scalar,
    upload_f32_exact,
)
from comet_tpu.indexes.ivf import _ivf_search_kernel, build_chunked_lists
from comet_tpu.io import serial
from comet_tpu.ops.distance import preprocess
from comet_tpu.ops.graph import (
    beam_search_layer0,
    nearest_entry,
    scatter_graph_update,
)
from comet_tpu.ops.topk import IDX_SENTINEL
from comet_tpu.types import (
    DistanceKind,
    InvalidConfigError,
    VectorIndexKind,
)

MAGIC = b"CHNW"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)

MAX_LEVEL = 16  # hnsw_index.go:474-484 cap
# Queries per beam dispatch: a larger chunk spreads the while_loop's
# per-iteration launch cost over more queries (2048 ran 2.2x the QPS of 256
# at 1M x 128 on an H100). Each query carries a visited bitmask of
# capacity/8 bytes, so VISITED_BYTES_MAX caps a dispatch's total.
HNSW_QUERY_CHUNK = 2048
VISITED_BYTES_MAX = 1 << 30
BUILD_SUB_BATCH = 512
# Beam candidates expanded per while_loop iteration (see ops/graph.py):
# higher = fewer sequential iterations on device. 8 at search kept
# recall@100 unchanged and ran 2.5x the QPS of 1 at 1M on an H100;
# construction keeps 1 (its candidate pools set graph quality).
SEARCH_EXPAND = 8
BUILD_EXPAND = 1
# Seeded beam: corpora below this take the classic entry-point start (the
# probe scan needs enough rows per cell to be worth its dispatch).
SEED_MIN_N = 1 << 15
# Seed-table rebuild debounce: the seed cells' inverted lists are rebuilt
# only when accumulated adds+removes exceed max(SEED_REBUILD_MIN, frac *
# layout size); removals in between are masked by validity at scan time
# (mutation-interleaved serving must not rebuild and re-upload the lists
# per add).
SEED_REBUILD_MIN = 8192
SEED_REBUILD_FRAC = 0.125
# An initial add_batch of at least this many vectors into an EMPTY index
# takes the kNN bulk-build path (ops/graph_build.py) instead of
# incremental insertion rounds.
BULK_BUILD_MIN = 4096


@dataclass
class HNSWConfig:
    """Graph parameters (DefaultHNSWConfig = (16, 200, 200),
    hnsw_index.go:95-97).

    search_iters bounds the lockstep beam's expansion iterations (the
    device loop's real work knob). 0 = derive from the padded ef (or the
    seeded stop window) — the reference has no equivalent because its
    beam is sequential (hnsw_index.go:565-629).

    seed_search enables the IVF-SEEDED beam (n >= SEED_MIN_N): the beam
    starts from the top candidates of a cluster-probe scan over ~sqrt(n)
    k-means cells (the IVF list walk, indexes/ivf.py) instead of a single
    entry point, and terminates on the k-window bound instead of the ef
    bound — the graph only repairs cell-boundary misses. seed_nprobe=0
    derives nlist/64 (min 2). seed_stop sets the seeded k-window width
    (0 = max(2*k_pad, 64), capped at ef_pad). seed_width caps how many beam
    rows the probe scan seeds (0 = min(stop, 128))."""

    m: int = 16
    ef_construction: int = 200
    ef_search: int = 200
    search_iters: int = 0
    seed_search: bool = True
    seed_nprobe: int = 0
    seed_stop: int = 0
    seed_width: int = 0


class HNSWIndex(BaseVectorIndex):
    """Hierarchical navigable small-world index (reference:
    hnsw_index.go:50-172)."""

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        config: HNSWConfig | None = None,
        seed: int = 0,
    ):
        super().__init__(dim, distance_kind)
        self._cfg = config or HNSWConfig()
        if self._cfg.m <= 0:
            raise InvalidConfigError("M must be positive")
        if self._cfg.ef_construction <= 0:
            raise InvalidConfigError("efConstruction must be positive")
        cap = self._store.capacity
        self._levels = np.full(cap, -1, dtype=np.int32)
        self._sqn0 = np.zeros(cap, dtype=np.float32)  # host sqnorm cache
        self._adj0 = np.full((cap, 2 * self._cfg.m), -1, dtype=np.int32)
        self._upper: dict[int, np.ndarray] = {}
        self._entry_slot = -1
        self._max_level = -1
        self._rng = np.random.default_rng(seed)
        # device mirrors (incrementally updated during builds)
        self._dev_cap = 0
        self._dev_vectors = None
        self._dev_sqnorms = None
        self._dev_adj0 = None
        self._dev_valid_version = -1
        self._dev_valid = None
        self._graph_version = 0
        # level>=1 member tables for exact entry selection (search path)
        self._dev_l1 = None
        self._dev_l1_version = -1
        # IVF-seeded beam state (seed cells' chunked inverted lists)
        self._seed_state = None
        self._seed_version = -1
        self._seed_centroids = None
        self._seed_trained_n = 0
        # incremental seed maintenance (per-slot assignment cache +
        # debounced layout rebuild — serving mutations must not pay a full
        # O(n*nlist) reassignment + table re-upload per add/remove)
        self._seed_assign = None
        self._seed_assign_n = 0
        self._seed_layout_n = 0
        self._seed_layout_deleted = 0

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.HNSW

    def train(self, vectors=None) -> None:
        """HNSW requires no training (parity)."""
        return None

    @property
    def config(self) -> HNSWConfig:
        return self._cfg

    def set_ef_search(self, ef: int) -> None:
        """Default search beam width (hnsw_index.go:463-467)."""
        self._cfg.ef_search = int(ef)

    def _effective_ef(self, override: int | None) -> int:
        ef = override if override and override > 0 else self._cfg.ef_search
        if ef <= 0:
            ef = self._cfg.ef_construction  # 0 falls back (hnsw_index.go:185-187)
        return ef

    # -- level sampling ------------------------------------------------------

    def _sample_levels(self, n: int) -> np.ndarray:
        """Geometric levels: P(level >= L) = (1/M)^L, capped at 16
        (hnsw_index.go:474-484)."""
        u = self._rng.random(n)
        levels = np.floor(np.log(np.maximum(u, 1e-300)) / np.log(1.0 / self._cfg.m))
        return np.minimum(levels, MAX_LEVEL).astype(np.int32)

    # -- host/device array management ---------------------------------------

    def _grow_host(self) -> None:
        cap = self._store.capacity
        if len(self._levels) >= cap:
            return
        levels = np.full(cap, -1, dtype=np.int32)
        levels[: len(self._levels)] = self._levels
        self._levels = levels
        sqn = np.zeros(cap, dtype=np.float32)
        sqn[: len(self._sqn0)] = self._sqn0
        self._sqn0 = sqn
        adj0 = np.full((cap, 2 * self._cfg.m), -1, dtype=np.int32)
        adj0[: len(self._adj0)] = self._adj0
        self._adj0 = adj0
        for lvl in list(self._upper):
            up = np.full((cap, self._cfg.m), -1, dtype=np.int32)
            up[: len(self._upper[lvl])] = self._upper[lvl]
            self._upper[lvl] = up

    def _ensure_device(self) -> None:
        """(Re)create device mirrors when capacity changes."""
        cap = self._store.capacity
        if self._dev_cap != cap:
            from comet_tpu.indexes.base import upload_f32_exact

            self._dev_vectors = upload_f32_exact(self._store.vectors)
            self._dev_sqnorms = jnp.sum(self._dev_vectors * self._dev_vectors, axis=1)
            self._dev_adj0 = jnp.asarray(self._adj0)
            self._dev_cap = cap
            self._dev_valid_version = -1

    def _sync_valid(self) -> None:
        if self._dev_valid_version != self._store.version:
            self._dev_valid = jnp.asarray(self._store.valid)
            self._dev_valid_version = self._store.version

    def _scatter_device(self, slots: np.ndarray, adj_rows_touched: np.ndarray) -> None:
        """Push new vectors + touched adjacency rows to the device mirrors in
        ONE dispatch. Row counts are padded to power-of-two buckets (repeating
        row 0 with its current host value) so XLA compiles a handful of
        shapes, not one per round."""

        def pad_rows(rows: np.ndarray) -> np.ndarray:
            want = next_pow2(max(len(rows), 1), 8)
            if want == len(rows):
                return rows
            return np.concatenate([rows, np.zeros(want - len(rows), dtype=rows.dtype)])

        vec_rows = pad_rows(np.asarray(slots, dtype=np.int64))
        adj_rows = pad_rows(np.asarray(adj_rows_touched, dtype=np.int64))
        adj_values = jnp.asarray(self._adj0[adj_rows])
        adj_rows_dev = jnp.asarray(adj_rows)
        self._dev_vectors, self._dev_sqnorms, self._dev_adj0 = scatter_graph_update(
            self._dev_vectors,
            self._dev_sqnorms,
            self._dev_adj0,
            jnp.asarray(vec_rows),
            jnp.asarray(self._store.vectors[vec_rows]),
            adj_rows_dev,
            adj_values,
        )

    # -- host-side distance helpers -----------------------------------------

    def _dist_rows_cmp(
        self, a: np.ndarray, b: np.ndarray, bn: np.ndarray,
        an: np.ndarray | None = None,
    ) -> np.ndarray:
        """COMPARISON-ONLY pairwise-per-row scores a[i] vs b[i...]:
        a [n, d], b [n, m, d], bn [n, m] = b's cached squared norms.

        Used only for argsort/argmin during construction and descent, so
        L2 stays in the cheap squared domain (no sqrt/clamp) and the
        [n, m, d] elementwise norm reduce — the single hottest line of the
        round-2 build profile, ~1 ms/vector — is replaced by a [n, m]
        gather from the `_sqn0` cache. einsum, not matmul: np.matmul's
        batched tiny-gemv path is ~3x slower here (per-batch BLAS call
        overhead)."""
        ip = np.einsum("nd,nmd->nm", a, b)
        if self._distance_kind == DistanceKind.COSINE:
            return 1.0 - np.clip(ip, -1.0, 1.0)
        if an is None:
            an = (a * a).sum(axis=1)
        return an[:, None] + bn - 2 * ip

    def _descend(self, queries: np.ndarray) -> np.ndarray:
        """Greedy descent through upper layers (vectorized over queries).
        Returns per-query layer-0 entry slots."""
        q = queries.shape[0]
        cur = np.full(q, self._entry_slot, dtype=np.int64)
        qn = (queries * queries).sum(axis=1)
        ev = self._store.vectors[self._entry_slot][None, :]
        cur_d = self._dist_rows_cmp(
            queries,
            np.broadcast_to(ev, (q, 1, self._dim)),
            np.broadcast_to(self._sqn0[self._entry_slot], (q, 1)),
            an=qn,
        )[:, 0]
        for level in range(self._max_level, 0, -1):
            adj = self._upper.get(level)
            if adj is None:
                continue
            for _ in range(64):  # safety cap; greedy converges fast
                neigh = adj[cur]                      # [Q, M]
                mask = neigh >= 0
                if not mask.any():
                    break
                safe = np.maximum(neigh, 0)
                nv = self._store.vectors[safe]
                nd = self._dist_rows_cmp(queries, nv, self._sqn0[safe], an=qn)
                nd = np.where(mask, nd, np.inf)
                best = nd.argmin(axis=1)
                bd = nd[np.arange(q), best]
                move = bd < cur_d
                if not move.any():
                    break
                cur = np.where(move, neigh[np.arange(q), best], cur)
                cur_d = np.where(move, bd, cur_d)
        return cur.astype(np.int32)

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
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
            self._insert_preprocessed(id_arr, prepped)
        return id_arr.tolist()

    def _vectors_of_slots(self, slots: np.ndarray) -> np.ndarray:
        return self._store.vectors[slots]

    def _insert_preprocessed(self, id_arr: np.ndarray, prepped: np.ndarray) -> None:
        """Batched insertion rounds (see module docstring); an initial bulk
        load of an EMPTY index takes the kNN-derived bulk-build path
        instead (ops/graph_build.py) — device matmuls instead of per-round
        beam searches."""
        was_empty = self._store.n == 0 and self._entry_slot < 0
        slots = self._store.add_batch(id_arr, prepped)
        self._grow_host()
        levels = self._sample_levels(len(slots))
        self._levels[slots] = levels
        # einsum, not (p*p).sum: the squared temp allocates [n, d] fresh
        # pages, which this environment's memory subsystem services at
        # ~8 MB/s (measured 13s at 200k x 128) — the fused reduce is ~500x
        self._sqn0[slots] = np.einsum("nd,nd->n", prepped, prepped)

        if was_empty and len(slots) >= BULK_BUILD_MIN:
            self._bulk_build(levels)
            return
        self._ensure_device()
        for lo in range(0, len(slots), BUILD_SUB_BATCH):
            sub = slots[lo : lo + BUILD_SUB_BATCH]
            sub_levels = levels[lo : lo + BUILD_SUB_BATCH]
            self._insert_round(np.asarray(sub), sub_levels)

    def _bulk_build(self, levels: np.ndarray) -> None:
        """Whole-graph construction by staged exact-kNN rounds (module
        docstring of ops/graph_build.py). Only valid on a freshly-loaded
        index: slots are [0, n) and `levels` covers them in slot order."""
        import os as _os
        import time as _time

        from comet_tpu.ops.graph_build import BulkGraphBuilder

        _timing = bool(_os.environ.get("COMET_BULK_TIMING"))
        n = self._store.n
        m = self._cfg.m
        builder = BulkGraphBuilder(
            self._store.vectors, n, self._distance_kind
        )
        t0 = _time.perf_counter() if _timing else 0.0
        self._adj0[:n] = builder.build_layer(None, m, 2 * m)[:n]
        if _timing:
            print(f"  adj0 install: {_time.perf_counter() - t0:.2f}s", flush=True)

        max_level = int(levels.max())
        for lvl in range(1, max_level + 1):
            members = np.flatnonzero(self._levels[:n] >= lvl).astype(np.int32)
            self._ensure_level(lvl)
            if len(members) < 2:
                continue
            adj = builder.build_layer(members, m, m)
            self._upper[lvl][members] = adj[members]
        dev = builder.device_mirror()

        top = np.flatnonzero(self._levels[:n] == max_level)
        self._entry_slot = int(top[0])
        self._max_level = max_level
        self._graph_version += 1

        # install device mirrors directly: the kNN pass already uploaded
        # the padded corpus, so only the adjacency moves host->device here
        t0 = _time.perf_counter() if _timing else 0.0
        cap = self._store.capacity
        if dev is not None and dev[0].shape[0] == cap:
            self._dev_vectors, self._dev_sqnorms = dev
            self._dev_adj0 = jnp.asarray(self._adj0)
            self._dev_cap = cap
            self._dev_valid_version = -1
        else:
            self._dev_cap = 0  # force re-upload on next search
        if _timing:
            print(f"  mirror install: {_time.perf_counter() - t0:.2f}s", flush=True)

    def _insert_round(self, sub: np.ndarray, sub_levels: np.ndarray) -> None:
        cfg = self._cfg
        all_new = np.array(sub)
        vecs = self._store.vectors[sub]
        touched: set[int] = set()

        if self._entry_slot < 0:
            # bootstrap: first node becomes the entry point
            self._entry_slot = int(sub[0])
            self._max_level = int(sub_levels[0])
            for lvl in range(1, sub_levels[0] + 1):
                self._ensure_level(lvl)
            first, rest = sub[:1], sub[1:]
            if len(rest) == 0:
                self._scatter_device(all_new, np.asarray([], dtype=np.int64))
                return
            sub, sub_levels, vecs = rest, sub_levels[1:], vecs[1:]
            touched.add(int(first[0]))

        b = len(sub)
        # candidate pool: beam search over the existing graph...
        entries = self._descend(vecs)
        efc = cfg.ef_construction
        cand_d, cand_s = beam_search_layer0(
            jnp.asarray(vecs),
            jnp.asarray(entries),
            self._dev_adj0,
            self._dev_vectors,
            self._dev_sqnorms,
            jnp.ones(self._dev_cap, dtype=bool),  # traversal = all nodes
            jnp.asarray(np.float32(np.inf)),
            efc,
            efc,
            self._distance_kind,
            (4 * efc + 32) // BUILD_EXPAND + 16,
            BUILD_EXPAND,
            False,  # construction: results = beam (one sort per iteration)
        )
        cand_d = np.asarray(cand_d)
        cand_s = np.asarray(cand_s)
        # ...plus exact intra-round candidates so same-round nodes can link
        if b > 1:
            # all-pairs via BLAS matmul (an einsum over a broadcast view is
            # ~100x slower — no BLAS path)
            ip = vecs @ vecs.T
            if self._distance_kind == DistanceKind.COSINE:
                intra = 1.0 - np.clip(ip, -1.0, 1.0)
            else:
                sq = (vecs * vecs).sum(axis=1)
                intra = np.maximum(sq[:, None] + sq[None, :] - 2.0 * ip, 0.0)
                if self._distance_kind == DistanceKind.L2:
                    intra = np.sqrt(intra)
            np.fill_diagonal(intra, np.inf)
            order = np.argsort(intra, axis=1, kind="stable")[:, : cfg.m]
            intra_d = np.take_along_axis(intra, order, axis=1)
            intra_s = sub[order]
            cand_d = np.concatenate([cand_d, intra_d], axis=1)
            cand_s = np.concatenate([cand_s, intra_s.astype(np.int32)], axis=1)
            reorder = np.argsort(cand_d, axis=1, kind="stable")
            cand_d = np.take_along_axis(cand_d, reorder, axis=1)
            cand_s = np.take_along_axis(cand_s, reorder, axis=1)

        m = cfg.m
        # Beam results are unique per row (visited-set semantics) and
        # intra-round candidates are disjoint from them, so the merged,
        # distance-sorted candidate rows need no dedup: the forward
        # neighbors are simply the first M finite entries per row.
        finite = (cand_s != int(IDX_SENTINEL)) & np.isfinite(cand_d)
        neighbors = np.full((b, m), -1, dtype=np.int32)
        for i in range(b):
            row = cand_s[i][finite[i]][:m]
            neighbors[i, : len(row)] = row
        self._adj0[sub, :m] = neighbors
        touched.update(int(s) for s in sub)

        # Reverse edges, batched: group (neighbor <- new) pairs by neighbor,
        # append, and prune every touched neighbor row in ONE vectorized
        # distance pass (hnsw_index.go:535-546, 667-694 done per-edge there).
        valid = neighbors >= 0
        if valid.any():
            nbr = neighbors[valid].astype(np.int64)
            new = np.repeat(sub, valid.sum(axis=1))
            uniq = self._batch_reverse_edges(self._adj0, 2 * m, nbr, new)
            touched.update(int(u) for u in uniq)

        # Upper layers: few nodes have level > 0. Forward rows per node are
        # cheap; reverse edges batch per level (per-edge _connect_reverse
        # profiled at ~54% of total build time before this).
        upper_pairs: dict[int, tuple[list, list]] = {}
        for i in np.flatnonzero(sub_levels > 0):
            slot = int(sub[i])
            level = int(sub_levels[i])
            css = cand_s[i][finite[i]]
            for lvl in range(1, level + 1):
                self._ensure_level(lvl)
                at_level = css[self._levels[css] >= lvl][:m]
                self._upper[lvl][slot, : len(at_level)] = at_level
                if len(at_level):
                    nbrs, news = upper_pairs.setdefault(lvl, ([], []))
                    nbrs.extend(int(x) for x in at_level)
                    news.extend([slot] * len(at_level))
        for lvl, (nbrs, news) in upper_pairs.items():
            self._batch_reverse_edges(
                self._upper[lvl], m,
                np.asarray(nbrs, dtype=np.int64),
                np.asarray(news, dtype=np.int64),
            )

        best = int(np.argmax(sub_levels))
        if int(sub_levels[best]) > self._max_level:
            self._max_level = int(sub_levels[best])
            self._entry_slot = int(sub[best])

        self._graph_version += 1
        self._scatter_device(all_new, np.fromiter(touched, dtype=np.int64))

    def _ensure_dev_l1(self) -> None:
        """Device tables for exact entry selection: the level>=1 member
        slots, their bf16 vectors TRANSPOSED for the entry matmul, and
        squared norms — refreshed only when the graph changed."""
        if (
            self._dev_l1_version == self._graph_version
            and self._dev_l1 is not None
        ):
            return
        members = np.nonzero(self._levels[: self._store.capacity] >= 1)[0]
        if len(members) == 0:
            self._dev_l1 = None
            self._dev_l1_version = self._graph_version
            return
        slots = jnp.asarray(members.astype(np.int32))
        vecs_t = self._dev_vectors[slots].astype(jnp.bfloat16).T  # [d, M]
        sqn = self._dev_sqnorms[slots]
        self._dev_l1 = (vecs_t, sqn, slots)
        self._dev_l1_version = self._graph_version

    def _descend_for_search(self, qc):
        """Per-query layer-0 entry slots: the nearest level>=1 member via
        one bf16 device matmul (ops/graph.nearest_entry). The result stays
        ON DEVICE and chains into the beam dispatch. Lockstep greedy
        descent would pay the WORST query's hop count per level."""
        if self._max_level < 1 or not self._upper:
            return jnp.full(len(qc), self._entry_slot, dtype=jnp.int32)
        self._ensure_dev_l1()
        if self._dev_l1 is None:
            return jnp.full(len(qc), self._entry_slot, dtype=jnp.int32)
        vecs_t, sqn, slots = self._dev_l1
        return nearest_entry(jnp.asarray(qc), vecs_t, sqn, slots)

    def _ensure_level(self, level: int) -> None:
        if level not in self._upper:
            self._upper[level] = np.full(
                (self._store.capacity, self._cfg.m), -1, dtype=np.int32
            )

    def _batch_reverse_edges(
        self, adj: np.ndarray, capacity: int, nbr: np.ndarray, new: np.ndarray
    ) -> np.ndarray:
        """Append each reverse edge (new[i] into nbr[i]'s list) and prune
        every overflowing row to `capacity` nearest — one vectorized pass
        over all touched rows (hnsw_index.go:535-546, 667-694 per-edge).
        Returns the unique touched row indices."""
        order = np.argsort(nbr, kind="stable")
        nbr_s, new_s = nbr[order], new[order]
        uniq, starts, counts = np.unique(
            nbr_s, return_index=True, return_counts=True
        )
        maxc = int(counts.max())
        w0 = capacity
        cand_mat = np.full((len(uniq), w0 + maxc), -1, dtype=np.int64)
        cand_mat[:, :w0] = adj[uniq]
        rows = np.searchsorted(uniq, nbr_s)
        cols = np.arange(len(nbr_s)) - starts[rows]
        cand_mat[rows, w0 + cols] = new_s
        # Mutual selections make a new node appear both in a neighbor's
        # forward row and its appends — mask duplicate occurrences.
        cm_valid = cand_mat >= 0
        ordv = np.argsort(cand_mat, axis=1, kind="stable")
        sv = np.take_along_axis(cand_mat, ordv, axis=1)
        rep = np.zeros_like(cand_mat, dtype=bool)
        rep[:, 1:] = sv[:, 1:] == sv[:, :-1]
        dup = np.zeros_like(rep)
        np.put_along_axis(dup, ordv, rep, axis=1)
        keepable = cm_valid & ~dup
        cand_mat = np.where(keepable, cand_mat, -1)

        fill = keepable.sum(axis=1)
        over = fill > w0
        # under-capacity rows: compact left, no distances needed
        if (~over).any():
            rows_u = np.flatnonzero(~over)
            cm_u = cand_mat[rows_u]
            order_u = np.argsort(cm_u < 0, axis=1, kind="stable")
            adj[uniq[rows_u]] = np.take_along_axis(cm_u, order_u, axis=1)[
                :, :w0
            ].astype(np.int32)
        # overflowing rows (few): batched prune keeping the nearest
        if over.any():
            rows_o = np.flatnonzero(over)
            cm_o = cand_mat[rows_o]
            safe = np.maximum(cm_o, 0)
            cv = self._store.vectors[safe]
            d = self._dist_rows_cmp(
                self._store.vectors[uniq[rows_o]], cv, self._sqn0[safe],
                an=self._sqn0[uniq[rows_o]],
            )
            d = np.where(cm_o >= 0, d, np.inf)
            keep = np.argsort(d, axis=1, kind="stable")[:, :w0]
            adj[uniq[rows_o]] = np.take_along_axis(cm_o, keep, axis=1).astype(
                np.int32
            )
        return uniq

    def remove(self, node_id: int) -> None:
        """Soft delete: excluded from results, still routes traversal."""
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        """Hard-delete with slot compaction + adjacency remap + entry-point
        repair (hnsw_index.go:384-413)."""
        with self._lock:
            self._graph_version += 1
            old_cap = self._store.capacity
            keep = self._store.flush()
            n_new = len(keep)
            remap = np.full(old_cap, -1, dtype=np.int32)
            remap[keep] = np.arange(n_new, dtype=np.int32)

            def remap_adj(adj: np.ndarray, width: int) -> np.ndarray:
                out = np.full((len(adj), width), -1, dtype=np.int32)
                rows = adj[keep]
                vals = np.where(rows >= 0, remap[np.maximum(rows, 0)], -1)
                # compact rows: stable-sort valid entries ahead of -1 gaps
                order = np.argsort(vals < 0, axis=1, kind="stable")
                out[:n_new] = np.take_along_axis(vals, order, axis=1)
                return out

            self._adj0 = remap_adj(self._adj0, 2 * self._cfg.m)
            new_levels = np.full(old_cap, -1, dtype=np.int32)
            new_levels[:n_new] = self._levels[keep]
            self._levels = new_levels
            new_sqn = np.zeros(old_cap, dtype=np.float32)
            new_sqn[:n_new] = self._sqn0[keep]
            self._sqn0 = new_sqn
            for lvl in list(self._upper):
                self._upper[lvl] = remap_adj(self._upper[lvl], self._cfg.m)

            # entry-point repair
            if n_new == 0:
                self._entry_slot = -1
                self._max_level = -1
                self._upper = {}
            else:
                best = int(np.argmax(self._levels[:n_new]))
                self._entry_slot = best
                self._max_level = int(self._levels[best])
                self._upper = {
                    lvl: adj for lvl, adj in self._upper.items() if lvl <= self._max_level
                }
            self._dev_cap = 0  # force device re-upload

    # -- search ---------------------------------------------------------------

    def _search_batch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        return self._search_collect(self._search_launch(queries, builder))

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        """Submit the batch; the returned handle holds IN-FLIGHT device
        result arrays so search_stream / the hybrid coordinator can overlap
        the next batch's upload+compute with this batch's download."""
        store = self._store
        n_slots = store.n
        q_in = queries.shape[0]
        if n_slots == 0 or self._entry_slot < 0:
            return ("empty", q_in)

        k_eff = sanitize_k(builder._k, n_slots)
        ef = max(self._effective_ef(builder._ef_search), k_eff)
        k_pad = min(next_pow2(k_eff), store.capacity)
        ef_pad = next_pow2(ef, 16)

        qprep = preprocess(queries, self._distance_kind)
        qpad, q_real = pad_queries(qprep)

        self._ensure_device()
        self._sync_valid()
        allowed = self._dev_valid
        doc_filter = DocumentFilter(builder._document_ids)
        fmask = doc_filter.slot_mask(store.ids)
        if fmask is not None:
            allowed = jnp.logical_and(allowed, jnp.asarray(fmask))
        thr = threshold_scalar(builder._threshold)
        # result admission == beam membership unless something filters
        fused = (
            fmask is not None
            or builder._threshold > 0
            or store.deleted > 0
        )

        seeded = self._use_seed()
        if seeded:
            # seeds fill the beam with true near-neighbors, so the classic
            # ef-bound would expand ALL of them; the k-window bound stops
            # once expansion cannot change the returned top-k
            stop = min(self._cfg.seed_stop or max(2 * k_pad, 64), ef_pad)
            seed_k = min(self._cfg.seed_width or 128, stop)
            max_iters = self._cfg.search_iters or (
                (2 * stop) // SEARCH_EXPAND + 16
            )
        else:
            stop = None
            max_iters = self._cfg.search_iters or (
                (4 * ef_pad + 32) // SEARCH_EXPAND + 16
            )
        rows = max(256, min(HNSW_QUERY_CHUNK,
                            VISITED_BYTES_MAX * 8 // store.capacity))
        chunks = []
        for q0 in range(0, qpad.shape[0], rows):
            qc = upload_f32_exact(qpad[q0 : q0 + rows])
            if seeded:
                seed_d, seed_s = self._seed_scan(qc, seed_k)
                # the entry slot is only the fallback for empty seed rows
                entries = jnp.full(qc.shape[0], self._entry_slot, jnp.int32)
            else:
                seed_d = seed_s = None
                entries = self._descend_for_search(qc)
            chunks.append(
                beam_search_layer0(
                    qc, entries, self._dev_adj0, self._dev_vectors,
                    self._dev_sqnorms, allowed, thr, ef_pad, k_pad,
                    self._distance_kind, max_iters, SEARCH_EXPAND, fused,
                    seed_d=seed_d, seed_s=seed_s, stop=stop,
                )
            )
        return ("dev_chunks", chunks, q_real, k_eff, store.ids)

    def _search_collect(self, handle):
        return collect_device_handle(handle)

    def _seed_nlist(self, n: int) -> int:
        return max(64, min(4096, next_pow2(int(n ** 0.5))))

    def _assign_new_slots(self, n: int) -> None:
        """Extend the per-slot seed-assignment cache to cover [assign_n, n)
        — the only per-mutation cost of keeping the seed tables warm."""
        from comet_tpu.ops.kmeans import find_nearest_centroid

        if self._seed_assign is None or len(self._seed_assign) < self._store.capacity:
            a = np.full(self._store.capacity, -1, np.int32)
            if self._seed_assign is not None:
                a[: self._seed_assign_n] = self._seed_assign[: self._seed_assign_n]
            self._seed_assign = a
        if n <= self._seed_assign_n:
            return
        new_sl = np.arange(self._seed_assign_n, n)
        new_sl = new_sl[self._store.valid[new_sl]]
        ch = 1 << 18
        for i0 in range(0, len(new_sl), ch):
            sl = new_sl[i0 : i0 + ch]
            self._seed_assign[sl] = find_nearest_centroid(
                self._store.vectors[sl], self._seed_centroids
            )
        self._seed_assign_n = n

    def _ensure_seed(self):
        """Seed-cell inverted lists for the seeded beam, maintained
        INCREMENTALLY across mutations.

        K-means the corpus into ~sqrt(n) cells and lay the VALID slots out
        as fixed-size chunked lists (indexes/ivf.build_chunked_lists) for
        the IVF list walk. Per-slot assignments are cached and extended
        only for NEW slots; removals need nothing here (the scan masks by
        current validity); the lists are rebuilt only when the accumulated
        delta passes SEED_REBUILD_FRAC (slots added since the last layout
        are until then reachable only through beam expansion from nearby
        seeds — the graph covers them) or when a flush permutes slots / the
        cell count retrains."""
        from comet_tpu.ops.kmeans import kmeans

        if self._seed_version == self._store.version:
            return self._seed_state
        store = self._store
        n = store.n
        nlist = self._seed_nlist(n)
        retrain = (
            self._seed_centroids is None
            or len(self._seed_centroids) != nlist
            or n > 2 * self._seed_trained_n
        )
        # a flush compacts slots: every cached slot-indexed structure dies
        flushed = self._seed_state is not None and (
            n < self._seed_layout_n
            or store.deleted < self._seed_layout_deleted
        )
        if retrain:
            sample = store.vectors[:n]
            if n > (1 << 17):
                sel = self._rng.choice(n, 1 << 17, replace=False)
                sample = sample[np.sort(sel)]
            self._seed_centroids, _ = kmeans(
                sample, nlist, DistanceKind.L2_SQUARED, 10,
                return_assign=False,
            )
            self._seed_trained_n = n
        if retrain or flushed:
            self._seed_assign = None
            self._seed_assign_n = 0
        self._assign_new_slots(n)

        adds = n - self._seed_layout_n
        dels = max(store.deleted - self._seed_layout_deleted, 0)
        rebuild = (
            self._seed_state is None
            or retrain
            or flushed
            or (adds + dels)
            > max(SEED_REBUILD_MIN, int(self._seed_layout_n * SEED_REBUILD_FRAC))
        )
        if rebuild:
            assign = np.where(
                store.valid[:n], self._seed_assign[:n], -1
            ).astype(np.int32)
            chunk_slots, chunk_start, max_chunks = build_chunked_lists(
                assign, nlist
            )
            self._seed_state = {
                "nlist": nlist,
                "centroids": jnp.asarray(self._seed_centroids),
                "chunk_slots": jnp.asarray(chunk_slots),
                "chunk_start": jnp.asarray(chunk_start),
                "max_chunks": max_chunks,
            }
            self._seed_layout_n = n
            self._seed_layout_deleted = store.deleted
        self._seed_version = store.version
        return self._seed_state

    def _seed_scan(self, qc, k: int):
        """Top-k cluster-probe seeds for one device query chunk: (seed_d,
        seed_s) [Q, k] in the index's metric space, sorted (dist, slot)
        ascending with (inf, SENT) padding — the IVF list walk over the
        seed cells, restricted to live slots."""
        st = self._ensure_seed()
        self._ensure_device()
        self._sync_valid()
        nprobe = self._cfg.seed_nprobe or max(2, st["nlist"] // 64)
        nprobe = min(nprobe, st["nlist"])
        return _ivf_search_kernel(
            qc, st["centroids"], st["chunk_slots"], st["chunk_start"],
            self._dev_vectors, self._dev_sqnorms, self._dev_valid,
            np.float32(np.inf), k, self._distance_kind, nprobe,
            next_pow2(nprobe * st["max_chunks"], 4),
            coarse_kind=DistanceKind.L2_SQUARED,
        )

    def _use_seed(self) -> bool:
        return self._cfg.seed_search and self._store.n >= SEED_MIN_N

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CHNW v1: params + vectors + levels + adjacency. Flushes first."""
        with self._lock:
            self.flush()
            n = self._store.n
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            serial.write_u32(w, self._cfg.m)
            serial.write_u32(w, self._cfg.ef_construction)
            serial.write_u32(w, self._cfg.ef_search)
            serial.write_i64(w, self._entry_slot)
            serial.write_i64(w, self._max_level)
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            serial.write_array(w, self._store.vectors[:n])
            serial.write_array(w, self._levels[:n])
            serial.write_array(w, self._adj0[:n])
            serial.write_u32(w, len(self._upper))
            for lvl in sorted(self._upper):
                serial.write_u32(w, lvl)
                serial.write_array(w, self._upper[lvl][:n])
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        self._graph_version += 1
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        m = serial.read_u32(r)
        efc = serial.read_u32(r)
        efs = serial.read_u32(r)
        if kind != self._distance_kind or dim != self._dim:
            raise serial.SerializationError(
                f"param mismatch: index=({self._distance_kind.value}, dim={self._dim}), "
                f"stored=({kind.value}, dim={dim})"
            )
        if m != self._cfg.m or efc != self._cfg.ef_construction:
            raise serial.SerializationError(
                f"HNSW param mismatch: index=(M={self._cfg.m}, efC={self._cfg.ef_construction}), "
                f"stored=(M={m}, efC={efc})"
            )
        entry = serial.read_i64(r)
        max_level = serial.read_i64(r)
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        vectors = serial.read_array(r)
        levels = serial.read_array(r)
        adj0 = serial.read_array(r)
        n_upper = serial.read_u32(r)
        upper = {}
        for _ in range(n_upper):
            lvl = serial.read_u32(r)
            upper[lvl] = serial.read_array(r)
        if version >= 2:
            r.verify()
        if (
            len(ids) != n
            or vectors.shape != (n, dim)
            or len(levels) != n
            or adj0.shape != (n, 2 * m)
        ):
            raise serial.SerializationError("corrupt HNSW index payload")
        with self._lock:
            from comet_tpu.indexes.base import SlotStore

            self._cfg.ef_search = efs
            self._store = SlotStore(dim, capacity=max(n, 1))
            cap = self._store.capacity
            self._levels = np.full(cap, -1, dtype=np.int32)
            self._sqn0 = np.zeros(cap, dtype=np.float32)
            self._adj0 = np.full((cap, 2 * m), -1, dtype=np.int32)
            self._upper = {}
            if n:
                self._store.add_batch(ids.astype(np.uint32), vectors.astype(np.float32))
                v32 = self._store.vectors[:n]
                self._sqn0[:n] = (v32 * v32).sum(axis=1)
                self._levels[:n] = levels
                self._adj0[:n] = adj0
                for lvl, arr in upper.items():
                    grown = np.full((cap, m), -1, dtype=np.int32)
                    grown[:n] = arr
                    self._upper[lvl] = grown
            self._entry_slot = int(entry)
            self._max_level = int(max_level)
            self._dev_cap = 0
