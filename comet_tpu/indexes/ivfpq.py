"""IVFPQ vector index: IVF coarse quantizer + PQ on residuals.

Capability parity with the reference's IVFPQIndex (ivfpq_index.go,
ivfpq_index_search.go): coarse k-means partition, a single shared PQ
codebook set trained on residuals (vector - assigned centroid,
ivfpq_index.go:164-259), train needs >= nlist*10 vectors
(ivfpq_index.go:185), search recomputes a query residual + fresh LUT per
probed cluster (ivfpq_index_search.go:285-323) and sums LUT entries + sqrt
(ivfpq_index_search.go:384-390). Soft delete/flush/filters/threshold/
aggregation/autocut/reranker/serialization as elsewhere.

Design: a lockstep while_loop over fixed-size inverted-list chunks (the
IVF walk, indexes/ivf.py); each step builds every query's residual LUT for
its current probe in one einsum, gathers one chunk of that list's codes, and
computes ADC distances as a batched LUT gather-sum, merging into the
running [Q, k] with (score, slot) keys.

Extension over the reference: `with_nrefine(n)` — the README documents a
refinement stage the Go code never implements (README.md:1779 vs
ivfpq_index_search.go; SURVEY.md §7 known gaps). Here it works: when
`store_originals=True` (constructor flag), the top n ADC candidates are
re-ranked with exact distances on the stored originals.
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
from comet_tpu.ops.kmeans import kmeans_ivfpq_train
from comet_tpu.ops.topk import IDX_SENTINEL, INF, merge_topk

from comet_tpu.types import (
    DistanceKind,
    InvalidConfigError,
    NodeNotFoundError,
    NotTrainedError,
    VectorIndexKind,
)

MAGIC = b"CIPQ"
VERSION = 3  # v3: optional OPQ rotation; v2: CRC32 trailer (older readable)

IVFPQ_QUERY_CHUNK = 256


@partial(jax.jit, static_argnames=("k", "kind", "nprobe", "max_steps"))
def _ivfpq_search_kernel(
    queries: jax.Array,      # [Q, d]
    centroids: jax.Array,    # [nlist, d]
    codebooks: jax.Array,    # [M, Ksub, dsub]
    chunk_slots: jax.Array,  # [NC, C] int32, -1 padded (chunked lists)
    chunk_start: jax.Array,  # [nlist + 1] int32
    codes: jax.Array,        # [cap, M] int32
    valid: jax.Array,        # [cap] bool
    threshold: jax.Array,    # scalar f32
    k: int,
    kind: DistanceKind,
    nprobe: int,
    max_steps: int,
):
    """Batched IVFPQ probe-and-ADC over fixed-size list chunks.

    Same cursor-walk structure as the IVF kernel (see ivf.py): each step
    every query scans one 256-row chunk of its current probed list. The
    per-cluster residual LUT (ivfpq_index_search.go:285-323) is recomputed
    per step for each query's CURRENT probe — a [Q, M, Ksub] einsum, trivial
    next to the member-code gathers. Returns (scores [Q,k], slots [Q,k]).
    """
    Q, d = queries.shape
    M, Ksub, dsub = codebooks.shape
    cd = pairwise_scores(queries, centroids, kind)  # [Q, nlist]
    _, probes = lax.top_k(-cd, nprobe)              # [Q, nprobe]

    cn = jnp.sum(codebooks * codebooks, axis=2)     # [M, Ksub]
    rows = jnp.arange(Q)
    offs_m = jax.lax.broadcasted_iota(jnp.int32, (1, 1, M), 2) * Ksub

    def cond(state):
        step, probe_i, off, best_s, best_i = state
        return (step < max_steps) & jnp.any(probe_i < nprobe)

    def body(state):
        step, probe_i, off, best_s, best_i = state
        alive = probe_i < nprobe
        p = probes[rows, jnp.minimum(probe_i, nprobe - 1)]
        base = chunk_start[p]
        nch = chunk_start[p + 1] - base
        have = alive & (off < nch)
        chunk = jnp.minimum(base + off, chunk_slots.shape[0] - 1)

        # current probe's residual LUT
        resid = queries - centroids[p]
        rs = resid.reshape(Q, M, dsub)
        ip = jnp.einsum(
            "qmd,mkd->qmk", rs, codebooks,
            preferred_element_type=jnp.float32, precision=DEFAULT_PRECISION,
        )
        rn = jnp.sum(rs * rs, axis=2, keepdims=True)
        lut_flat = jnp.maximum(rn + cn[None, :, :] - 2.0 * ip, 0.0).reshape(
            Q, M * Ksub
        )

        slots = jnp.where(have[:, None], chunk_slots[chunk], -1)   # [Q, C]
        slots_c = jnp.maximum(slots, 0)
        member_codes = codes[slots_c].astype(jnp.int32)            # [Q, C, M]
        picked = jnp.take_along_axis(
            lut_flat[:, None, :], member_codes + offs_m, axis=2
        )                                                          # [Q, C, M]
        dist = jnp.sqrt(jnp.maximum(jnp.sum(picked, axis=2), 0.0))

        ok = (slots >= 0) & valid[slots_c] & (dist <= threshold)
        dist = jnp.where(ok, dist, INF)
        kk = min(k, dist.shape[1])
        s, pos = lax.top_k(-dist, kk)
        s = -s
        slot_sel = jnp.take_along_axis(slots, pos, axis=1)
        slot_sel = jnp.where(s == INF, IDX_SENTINEL, slot_sel)
        best_s, best_i = merge_topk(best_s, best_i, s, slot_sel, k)

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


@partial(jax.jit, static_argnames=("k", "kind"))
def _refine_device(
    qpad: jax.Array,     # [Q, d] preprocessed queries (zero pad rows)
    slots: jax.Array,    # [Q, C] i32 ADC candidates (IDX_SENTINEL pads)
    vectors: jax.Array,  # [cap, d] stored originals
    k: int,
    kind: DistanceKind,
):
    """Exact re-rank of the ADC top candidates on the stored originals,
    on device (the nrefine extension; README.md:1779 documents it, the Go
    code never ships it). L2 distances are summed over the differences, not
    expanded into norms and an inner product, so a candidate equal to the
    query scores exactly 0. Tie order: (exact score asc, slot asc).
    Returns (scores [Q, k], slots [Q, k])."""
    sent = jnp.int32(IDX_SENTINEL)
    pad = slots == sent
    v = vectors[jnp.where(pad, 0, slots)]                # [Q, C, d]
    if kind == DistanceKind.COSINE:
        ip = jnp.einsum(
            "qd,qcd->qc", qpad, v,
            preferred_element_type=jnp.float32, precision=DEFAULT_PRECISION,
        )
        exact = 1.0 - jnp.clip(ip, -1.0, 1.0)
    else:
        diff = v - qpad[:, None, :]
        exact = jnp.sum(diff * diff, axis=-1)
        if kind == DistanceKind.L2:
            exact = jnp.sqrt(exact)
    exact = jnp.where(pad, INF, exact)
    sd, ss = lax.sort((exact, slots), dimension=1, num_keys=2)
    return sd[:, :k], ss[:, :k]


class IVFPQIndex(BaseVectorIndex):
    """IVF + PQ-on-residuals index (reference: ivfpq_index.go:54-100)."""

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        nlist: int = 100,
        m: int | None = None,
        nbits: int = 8,
        store_originals: bool = False,
        opq: bool = False,
        opq_iters: int = 6,
    ):
        super().__init__(dim, distance_kind)
        if nlist <= 0:
            raise InvalidConfigError("nlist must be positive")
        if m is None:
            from comet_tpu.indexes.pq import calculate_pq_params

            m, nbits = calculate_pq_params(dim)
        if m <= 0:
            raise InvalidConfigError("parameter M must be positive")
        if dim % m != 0:
            raise InvalidConfigError(f"dimension {dim} must be divisible by M {m}")
        if nbits <= 0 or nbits > 16:
            raise InvalidConfigError("parameter Nbits must be in [1,16]")
        self._nlist = nlist
        self._m = m
        self._nbits = nbits
        self._ksub = 1 << nbits
        self._dsub = dim // m
        self._store_originals = store_originals
        # OPQ extension (Ge et al., CVPR 2013 — beyond the reference, like
        # nrefine): learn an orthogonal rotation R that aligns the PQ
        # subspace split with the data before quantization. The MODEL
        # (centroids, codebooks, codes) lives in rotated coordinates; the
        # dense-scan path rotates reconstructions BACK once at build time,
        # so serving in original coordinates pays zero per-query cost and
        # stored originals / nrefine stay in user space.
        self._opq = bool(opq)
        self._opq_iters = int(opq_iters)
        self._rot: np.ndarray | None = None
        if not store_originals:
            # vector-less store: only codes + residual assignment kept
            from comet_tpu.indexes.base import SlotStore

            self._store = SlotStore(0)
        self._codes = np.zeros((self._store.capacity, m), dtype=np.int32)
        self._assign = np.full(self._store.capacity, -1, dtype=np.int32)
        self._centroids: np.ndarray | None = None
        self._codebooks: np.ndarray | None = None
        self._trained = False
        self._dev_version = -1
        self._dev = None

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.IVFPQ

    def trained(self) -> bool:
        return self._trained

    @property
    def nlist(self) -> int:
        return self._nlist

    @property
    def m(self) -> int:
        return self._m

    @property
    def nbits(self) -> int:
        return self._nbits

    def default_nprobes(self) -> int:
        return max(int(math.sqrt(self._nlist)), 1)

    # -- training --------------------------------------------------------------

    def train(self, vectors: np.ndarray, max_iter: int = 20) -> None:
        """Coarse k-means + shared PQ codebooks on residuals
        (ivfpq_index.go:164-259); needs >= nlist*10 vectors."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if len(vectors) < self._nlist * 10:
            raise InvalidConfigError(
                f"need at least {self._nlist * 10} training vectors "
                f"(nlist*10), got {len(vectors)}"
            )
        prepped = preprocess(vectors, self._distance_kind)
        rot = self._train_opq(prepped, max_iter) if self._opq else None
        if rot is not None:
            prepped = prepped @ rot
        # Fused device path: one upload, coarse loop, device residuals,
        # subspace loop (ivfpq_index.go:164-259 computes residuals on host)
        centroids, codebooks = kmeans_ivfpq_train(
            prepped, self._nlist, self._distance_kind,
            self._m, self._ksub, max_iter,
        )
        with self._lock:
            self._rot = rot
            self._centroids = centroids
            self._codebooks = codebooks
            self._trained = True
            self._dev_version = -1

    def _train_opq(self, prepped: np.ndarray, max_iter: int) -> np.ndarray:
        """Learn the OPQ rotation by the non-parametric alternation
        (OPQ-NP): train a cheap (coarse + PQ) model in the current rotated
        space, reconstruct, then solve the orthogonal Procrustes problem
        R = UV^T of Y^T·Ŷ for the rotation that best maps the data onto
        its reconstructions. Model fits and reconstructions run on device;
        only the d x d SVD runs on host."""
        import jax

        from comet_tpu.ops.adc import ivfpq_assign_encode, pq_decode

        d = self._dim
        y_dev = jnp.asarray(prepped)
        rot = np.eye(d, dtype=np.float32)

        @jax.jit
        def rotate(y, r):
            return jnp.dot(y, r, preferred_element_type=jnp.float32,
                           precision=DEFAULT_PRECISION)

        @jax.jit
        def chunk_m(y_chunk, z_chunk, cent, books):
            # encode + reconstruct + partial Procrustes accumulator for ONE
            # chunk: the whole-set encode materializes a [n, M, Ksub] f32
            # intermediate (16 GB at 1M x m=16) — an HBM OOM the add path
            # already avoids by streaming (code review r5)
            assign, codes = ivfpq_assign_encode(
                z_chunk, cent, books, self._distance_kind
            )
            rec = cent[assign] + pq_decode(codes, books)
            return jnp.dot(y_chunk.T, rec, preferred_element_type=jnp.float32,
                           precision=DEFAULT_PRECISION)

        inner_iter = max(2, min(4, max_iter))
        chunk = 1 << 17
        n = len(prepped)
        for _ in range(max(self._opq_iters, 1)):
            rot_d = jnp.asarray(rot)
            z = np.asarray(rotate(y_dev, rot_d))
            cent, books = kmeans_ivfpq_train(
                z, self._nlist, self._distance_kind,
                self._m, self._ksub, inner_iter,
            )
            cent_d, books_d = jnp.asarray(cent), jnp.asarray(books)
            mm = np.zeros((d, d), np.float64)
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                mm += np.asarray(chunk_m(
                    y_dev[lo:hi], jnp.asarray(z[lo:hi]), cent_d, books_d
                ), dtype=np.float64)
            u, _, vt = np.linalg.svd(mm)
            rot = (u @ vt).astype(np.float32)
        return rot

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Assign to nearest centroid, encode the residual
        (ivfpq_index.go:279-319), batched."""
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
        # Fused device-side assign+residual+encode, streamed in chunks so
        # each vector is transferred to the device exactly once.
        from functools import partial as _partial

        from comet_tpu.ops.adc import ivfpq_assign_encode, stream_device_map

        cent_dev = jnp.asarray(self._centroids)
        cb_dev = jnp.asarray(self._codebooks)
        rot_dev = jnp.asarray(self._rot) if self._rot is not None else None
        from comet_tpu.indexes.base import narrow_wire

        assign, codes = stream_device_map(
            _partial(
                ivfpq_assign_encode,
                centroids=cent_dev,
                codebooks=cb_dev,
                kind=self._distance_kind,
                rot=rot_dev,
            ),
            narrow_wire(prepped),  # int-valued corpora: 1/4 the bytes
            chunk_rows=1 << 17,
        )
        assign = assign.astype(np.int32)
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            stored = prepped if self._store_originals else np.zeros(
                (len(id_arr), 0), dtype=np.float32
            )
            slots = self._store.add_batch(id_arr, stored)
            if self._store.capacity > len(self._codes):
                grown_c = np.zeros((self._store.capacity, self._m), dtype=np.int32)
                grown_c[: len(self._codes)] = self._codes
                self._codes = grown_c
                grown_a = np.full(self._store.capacity, -1, dtype=np.int32)
                grown_a[: len(self._assign)] = self._assign
                self._assign = grown_a
            self._codes[slots] = codes
            self._assign[slots] = assign
        return id_arr.tolist()

    def remove(self, node_id: int) -> None:
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        with self._lock:
            keep = self._store.flush()
            self._codes[: len(keep)] = self._codes[keep]
            self._codes[len(keep):] = 0
            kept_assign = self._assign[keep]
            self._assign[: len(kept_assign)] = kept_assign
            self._assign[len(kept_assign):] = -1

    # -- search ---------------------------------------------------------------

    def _decode(self, slot: int) -> np.ndarray:
        """Reconstruct: centroid + decoded residual."""
        from comet_tpu.ops.adc import pq_decode

        resid = np.asarray(
            pq_decode(jnp.asarray(self._codes[slot][None, :]), jnp.asarray(self._codebooks))
        )[0]
        rec = self._centroids[self._assign[slot]] + resid
        if self._rot is not None:
            rec = rec @ self._rot.T  # model space -> user space
        return rec

    def _lookup_node_vectors(self, node_ids):
        out = []
        for node_id in node_ids:
            slot = self._store.id_to_slot.get(int(node_id))
            if slot is None:
                raise NodeNotFoundError(f"node ID {node_id} not found in index")
            if self._store_originals:
                out.append(np.array(self._store.vectors[slot]))
            else:
                out.append(self._decode(slot))
        return out

    def _result_node(self, node_id: int) -> VectorNode:
        slot = self._store.id_to_slot[int(node_id)]
        if self._store_originals:
            return VectorNode(node_id, np.array(self._store.vectors[slot]))
        return VectorNode(node_id, self._decode(slot))

    def _device_state_ivfpq(self):
        if self._dev_version != self._store.version:
            n = self._store.n
            from comet_tpu.indexes.ivf import build_chunked_lists

            chunk_slots, chunk_start, max_chunks = build_chunked_lists(
                self._assign[:n], self._nlist
            )
            code_np = (
                self._codes.astype(np.uint8) if self._nbits <= 8
                else self._codes
            )  # codes stay narrow on device; kernels cast to i32 on read
            self._dev = (
                jnp.asarray(self._centroids),
                jnp.asarray(self._codebooks),
                jnp.asarray(chunk_slots),
                jnp.asarray(chunk_start),
                max_chunks,
                jnp.asarray(code_np),
                jnp.asarray(self._store.valid),
            )
            self._dev_version = self._store.version
        return self._dev

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
        nrefine = 0
        if builder._nrefine and self._store_originals:
            nrefine = max(int(builder._nrefine), k_eff)
        k_pad = min(next_pow2(max(k_eff, nrefine)), store.capacity)
        nprobe = self._sanitize_nprobes(builder._nprobes)
        take = max(k_eff, nrefine)

        qprep = preprocess(queries, self._distance_kind)
        qpad, q_real = pad_queries(qprep)

        doc_filter = DocumentFilter(builder._document_ids)
        fmask = doc_filter.slot_mask(store.ids)
        valid = jnp.asarray(store.valid)
        if fmask is not None:
            valid = jnp.logical_and(valid, jnp.asarray(fmask))
        thr = threshold_scalar(builder._threshold)

        (
            centroids, codebooks, chunk_slots, chunk_start, max_chunks, codes, _v,
        ) = self._device_state_ivfpq()
        # centroids/codebooks live in OPQ model space, so queries rotate in
        # (distances are rotation-invariant); nrefine re-ranks against the
        # user-space originals with the unrotated queries
        qmodel = qpad @ self._rot if self._rot is not None else qpad
        max_steps = next_pow2(nprobe * max_chunks, 4)
        if nrefine:
            vecs_dev = store.device_state()[0]
        chunks = []
        for q0 in range(0, qpad.shape[0], IVFPQ_QUERY_CHUNK):
            qc = upload_f32_exact(qmodel[q0 : q0 + IVFPQ_QUERY_CHUNK])
            s, i = _ivfpq_search_kernel(
                qc, centroids, codebooks, chunk_slots, chunk_start, codes,
                valid, thr, k_pad, self._distance_kind, nprobe, max_steps,
            )
            if nrefine:
                qu = qc if self._rot is None else upload_f32_exact(
                    qpad[q0 : q0 + IVFPQ_QUERY_CHUNK]
                )
                s, i = _refine_device(
                    qu, i[:, :take], vecs_dev, k_eff, self._distance_kind
                )
            chunks.append((s, i))
        return ("dev_chunks", chunks, q_real, k_eff, store.ids)

    def _search_collect(self, handle):
        from comet_tpu.indexes.base import collect_device_handle

        return collect_device_handle(handle)

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CIPQ v1: params + centroids + codebooks + ids/codes/assignments."""
        with self._lock:
            self.flush()
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            serial.write_u32(w, self._nlist)
            serial.write_u32(w, self._m)
            serial.write_u32(w, self._nbits)
            serial.write_u32(w, 1 if self._store_originals else 0)
            serial.write_u32(w, 1 if self._trained else 0)
            serial.write_u32(w, 1 if self._rot is not None else 0)
            if self._rot is not None:
                serial.write_array(w, self._rot)
            if self._trained:
                serial.write_array(w, self._centroids)
                serial.write_array(w, self._codebooks)
            n = self._store.n
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            code_dtype = np.uint8 if self._nbits <= 8 else np.uint32
            serial.write_array(w, self._codes[:n].astype(code_dtype))
            serial.write_array(w, self._assign[:n])
            if self._store_originals:
                serial.write_array(w, self._store.vectors[:n])
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        nlist = serial.read_u32(r)
        m = serial.read_u32(r)
        nbits = serial.read_u32(r)
        store_originals = bool(serial.read_u32(r))
        if kind != self._distance_kind or dim != self._dim:
            raise serial.SerializationError(
                f"param mismatch: index=({self._distance_kind.value}, dim={self._dim}), "
                f"stored=({kind.value}, dim={dim})"
            )
        if nlist != self._nlist or m != self._m or nbits != self._nbits:
            raise serial.SerializationError(
                f"IVFPQ param mismatch: index=(nlist={self._nlist}, M={self._m}, "
                f"Nbits={self._nbits}), stored=(nlist={nlist}, M={m}, Nbits={nbits})"
            )
        trained = bool(serial.read_u32(r))
        rot = None
        if version >= 3 and serial.read_u32(r):
            rot = serial.read_array(r).astype(np.float32)
        centroids = serial.read_array(r) if trained else None
        codebooks = serial.read_array(r) if trained else None
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        codes = serial.read_array(r)
        assign = serial.read_array(r)
        vectors = serial.read_array(r) if store_originals else None
        if version >= 2:
            r.verify()
        if len(ids) != n or codes.shape != (n, m) or len(assign) != n:
            raise serial.SerializationError("corrupt IVFPQ index payload")
        with self._lock:
            from comet_tpu.indexes.base import SlotStore

            self._store_originals = store_originals
            self._rot = rot
            self._opq = rot is not None
            self._centroids = centroids
            self._codebooks = codebooks
            self._trained = trained
            self._store = SlotStore(dim if store_originals else 0, capacity=max(n, 1))
            self._codes = np.zeros((self._store.capacity, self._m), dtype=np.int32)
            self._assign = np.full(self._store.capacity, -1, dtype=np.int32)
            if n:
                stored = (
                    vectors.astype(np.float32)
                    if store_originals
                    else np.zeros((n, 0), dtype=np.float32)
                )
                slots = self._store.add_batch(ids.astype(np.uint32), stored)
                self._codes[slots] = codes.astype(np.int32)
                self._assign[slots] = assign.astype(np.int32)
            self._dev_version = -1
