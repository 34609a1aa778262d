"""Bulk HNSW graph construction — staged exact-kNN rounds on the device.

The incremental insert path (indexes/hnsw.py:_insert_round) is the
reference's per-node algorithm batched (hnsw_index.go:486-560): every
512-vector round runs a device beam of several hundred sequential
iterations, then prunes reverse edges in host numpy.

A first bulk design (every row = its exact nearest neighbors) built
non-navigable graphs: recall@100 collapsed to ~0.2 because pure-kNN
adjacency has only short edges, so greedy descent/beam search cannot
cross regions. HNSW's navigability comes from INSERTION ORDER: nodes
inserted while the graph was small keep long-range edges. This builder
reproduces exactly that with device matmuls:

  - a layer's nodes are processed in DOUBLING-SIZE STAGES (64, 64, 128,
    ...); stage nodes take their forward edges from an EXACT kNN against
    the prefix [0, stage_end) — the reference's insert loop with
    efConstruction = infinity, so early nodes keep the long-range edges
    that make the graph navigable;
  - each stage's kNN is one masked flat-scan sweep with the exact block
    top-k the flat index serves queries with (ops/topk.block_topk).
    ALL layers share one capacity-shaped device corpus; the "first hi
    members of this layer" predicate is a runtime member-rank mask, so
    every stage of every layer reuses the same compiled shapes;
  - forward edges are selected from the kNN pool by the HNSW paper's
    SELECT-NEIGHBORS-HEURISTIC (admit a candidate iff it is closer to the
    node than to every already-admitted neighbor, then backfill nearest —
    hnswlib getNeighborsByHeuristic2 + keepPrunedConnections): exact-kNN
    pools alone are still non-navigable;
  - reverse edges are deferred to ONE global append+re-select pass per
    layer (the stage kNN never reads the adjacency — candidates come from
    vector scans, not graph traversal — so per-stage append order does
    not exist to preserve). Overflowing rows re-select with the SAME
    heuristic: a distance-only prune strips hub rows of their long-range
    edges (measured 0.84 -> 0.995 recall@10 from heuristic re-selection).

The adjacency LIVES ON DEVICE for the whole build: stages chain
pipeline -> fused dedup/heuristic/select -> scatter without host
round-trips, and the reverse pass (edge sort, in-degree ranking, scatter,
chunked per-row re-select under lax.map) is a single jitted call.

Distances are kernel-domain (squared L2 / cosine distance) and
comparison-only. Tie order follows the library contract (distance asc,
slot asc). Quality is measured, not assumed: tests/bench score beam-search
recall@100 on bulk-built graphs against the exact-oracle ground truth.
"""

from __future__ import annotations

import os
import time

import numpy as np

_TIMING = bool(os.environ.get("COMET_BULK_TIMING"))

from comet_tpu.ops.topk import IDX_SENTINEL
from comet_tpu.types import DistanceKind

# Below this many prefix rows a host matmul beats a device dispatch.
HOST_KNN_MAX = 2048
# Canonical host-stage batch rows: every distinct device shape costs a
# multi-second cached-executable load per process, so ALL host stages of
# ALL layers pad to one (HOST_BP, pow2(pool+1)) finalize/scatter shape —
# measured 2-8 s/stage down to ~0.05 s after the first.
HOST_BP = 2048
# The stage ladder starts SMALL and doubles: long-range edges come from
# the early stages (a 4096-node first stage left upper layers single-stage
# pure-kNN and descent recall collapsed); total device FLOPs are
# independent of the stage count, and tiny stages are host matmuls.
FIRST_STAGE = 64
# Device kNN query rows per dispatch and corpus rows per scan step: the
# f32 distance tile is QUERY_CHUNK x KNN_SUPER_TILE (4 GB).
QUERY_CHUNK = 4096
KNN_SUPER_TILE = 1 << 18
FIN_CHUNK = 16384
RANK_NONE = np.int32(2**31 - 1)
SENT = int(IDX_SENTINEL)


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


class BulkGraphBuilder:
    """Shared state for building every layer of one HNSW graph: the
    capacity-padded corpus (uploaded once) plus the per-layer staged
    construction."""

    def __init__(self, vectors: np.ndarray, n: int, kind: DistanceKind):
        self.vectors = vectors  # [cap >= n, d]; rows >= n are padding
        self.n = n
        self.kind = kind
        self.cosine = kind == DistanceKind.COSINE
        self.dev = None  # (vectors, sqnorms) on device
        self._fin_corpus = None

    # -- device management -------------------------------------------------

    def _ensure_device(self):
        """Capacity-shaped device corpus + squared norms for the kNN
        sweeps, uploaded once per build."""
        if self.dev is not None:
            return
        import jax.numpy as jnp

        from comet_tpu.indexes.base import upload_f32_exact

        dev_vecs = upload_f32_exact(self.vectors)
        self.dev = (dev_vecs, jnp.sum(dev_vecs * dev_vecs, axis=1))

    def _finalize_corpus(self):
        """Device corpus for finalize/append gathers: the shared capacity
        corpus when it exists, else a lazily-cached upload (CPU backend /
        small builds)."""
        if self.dev is not None:
            return self.dev[0]
        if self._fin_corpus is None:
            import jax.numpy as jnp

            self._fin_corpus = jnp.asarray(self.vectors)
        return self._fin_corpus

    def device_mirror(self):
        """(vectors, sqnorms) device pair when it matches the caller's
        capacity — reusable as the index's device mirror."""
        if self.dev is not None and self.dev[0].shape[0] == len(self.vectors):
            return self.dev[0], self.dev[1]
        return None

    # -- kNN against a member prefix ---------------------------------------

    def _query_host(self, order: np.ndarray, lo: int, hi: int, k: int):
        """Host matmul kNN for tiny prefixes. Returns GLOBAL slots,
        (dist asc, slot asc) order, self included like the device path."""
        v = self.vectors[order[:hi]]
        q = v[lo:hi]
        ip = q @ v.T
        if self.cosine:
            d = 1.0 - np.clip(ip, -1.0, 1.0)
        else:
            sq = np.einsum("nd,nd->n", v, v)
            d = np.maximum(sq[lo:hi, None] + sq[None, :] - 2.0 * ip, 0.0)
        k = min(k, hi)
        sel = np.argsort(d, axis=1, kind="stable")[:, :k]
        dists = np.take_along_axis(d, sel, axis=1).astype(np.float32)
        slots = order[sel].astype(np.int32)
        return dists, slots

    # -- one layer ----------------------------------------------------------

    def build_layer(
        self,
        members: np.ndarray | None,
        m_forward: int,
        width: int,
        first_stage: int = FIRST_STAGE,
    ) -> np.ndarray:
        """Staged construction of one layer over `members` (global slots,
        ascending; None = all rows [0, n)). Returns adj [n, width] int32,
        -1 padded, GLOBAL slots — only member rows are populated."""
        import jax.numpy as jnp

        n = self.n
        order = (
            np.arange(n, dtype=np.int32)
            if members is None
            else np.asarray(members, dtype=np.int32)
        )
        nloc = len(order)
        if nloc <= 1:
            return np.full((n, width), -1, np.int32)

        use_dev_knn = nloc > HOST_KNN_MAX
        rank_dev = None
        t0 = time.perf_counter() if _TIMING else 0.0
        if use_dev_knn:
            self._ensure_device()
            rank = np.full(self.dev[0].shape[0], RANK_NONE, np.int32)
            rank[order] = np.arange(nloc, dtype=np.int32)
            rank_dev = jnp.asarray(rank)
        if _TIMING:
            print(
                f"    setup/upload: {time.perf_counter() - t0:.2f}s",
                flush=True,
            )

        corpus = self._finalize_corpus()
        fin = _make_finalize(self.cosine)
        adj_s = jnp.full((n, width), SENT, jnp.int32)
        adj_d = jnp.full((n, width), jnp.inf, jnp.float32)

        pool = 2 * m_forward
        # finalize emits 2*m_forward columns for EVERY layer (scatter slices
        # to the layer's width) so base and upper layers share one
        # executable; host stages share one canonical (bp, cp) shape too.
        out_w = max(width, 2 * m_forward)
        cp = _pow2(pool + 1)
        lo, hi = 0, min(first_stage, nloc)
        while lo < nloc:
            t0 = time.perf_counter() if _TIMING else 0.0
            k = min(pool + 1, hi)
            if use_dev_knn and hi > HOST_KNN_MAX:
                adj_s, adj_d = self._device_stage(
                    corpus, fin, adj_s, adj_d, order, rank_dev, lo, hi, k,
                    m_forward, width, out_w,
                )
                if _TIMING:
                    adj_s.block_until_ready()
                    print(
                        f"    stage[{lo}:{hi}) dev: "
                        f"{time.perf_counter() - t0:.2f}s",
                        flush=True,
                    )
            else:
                dists, slots = self._query_host(order, lo, hi, k)
                b = hi - lo
                bp = HOST_BP if b <= HOST_BP else _pow2(b)
                sg = np.full((bp, cp), SENT, np.int32)
                dg = np.full((bp, cp), np.inf, np.float32)
                sg[:b, : slots.shape[1]] = slots
                dg[:b, : slots.shape[1]] = dists
                own = np.full(bp, -2, np.int32)
                own[:b] = order[lo:hi]
                fs, fd = fin(
                    corpus, jnp.asarray(sg), jnp.asarray(dg),
                    jnp.asarray(own), min(m_forward, width), out_w,
                )
                rows = np.full(bp, n, np.int32)  # pad -> dropped
                rows[:b] = order[lo:hi]
                adj_s = _scatter_rows(adj_s, jnp.asarray(rows), fs, width)
                adj_d = _scatter_rows(adj_d, jnp.asarray(rows), fd, width)
                if _TIMING:
                    adj_s.block_until_ready()
                    print(
                        f"    stage[{lo}:{hi}) host: "
                        f"{time.perf_counter() - t0:.2f}s",
                        flush=True,
                    )
            lo, hi = hi, min(2 * hi, nloc)

        # global reverse append + heuristic re-selection, one device call.
        # The pad length floors at FIN_CHUNK on the device path so every
        # upper layer (whatever its member count) reuses one executable.
        t0 = time.perf_counter() if _TIMING else 0.0
        lp = _pow2(nloc)
        if use_dev_knn:
            lp = max(lp, FIN_CHUNK)
        order_pad = np.full(lp, n, np.int32)
        order_pad[:nloc] = order
        app = _make_append(self.cosine)
        adj_s = app(corpus, adj_s, adj_d, jnp.asarray(order_pad), width)
        if _TIMING:
            adj_s.block_until_ready()
            print(
                f"    append pass: {time.perf_counter() - t0:.2f}s",
                flush=True,
            )

        # sentinel -> -1 happened inside the append pass (on device)
        t0 = time.perf_counter() if _TIMING else 0.0
        out = np.asarray(adj_s)
        if _TIMING:
            print(
                f"    download: {time.perf_counter() - t0:.2f}s", flush=True
            )
        return out

    def _device_stage(
        self, corpus, fin, adj_s, adj_d, order, rank_dev, lo, hi, k,
        m_forward, width, out_w,
    ):
        """One device stage: chunked exact kNN against the member prefix
        -> fused finalize -> scatter, fully asynchronous (no host sync
        until the layer's final download)."""
        import jax.numpy as jnp

        from comet_tpu.ops.topk import block_topk

        n = self.n
        d = self.vectors.shape[1]
        vecs, sqn = self.dev
        prefix = rank_dev < hi                 # the first hi layer members
        inf = np.float32(np.inf)
        kind = DistanceKind.COSINE if self.cosine else DistanceKind.L2_SQUARED
        # ONE canonical chunk shape for every stage of every layer, so the
        # whole build compiles one kNN executable. Pad rows are zero
        # queries owned by no slot; their results scatter to row n and are
        # dropped. Each chunk gets FRESH host buffers: dispatch is
        # asynchronous and a backend may read (or alias) a host buffer after
        # this loop has moved on, so a pooled buffer refilled by the next
        # chunk would hand a pending stage another chunk's rows.
        canon = min(QUERY_CHUNK, _pow2(self.n))
        super_tile = min(KNN_SUPER_TILE, vecs.shape[0])
        for q0 in range(lo, hi, canon):
            qn = min(canon, hi - q0)
            rows = order[q0 : q0 + qn]
            qc = np.zeros((canon, d), np.float32)
            qc[:qn] = self.vectors[rows]
            own = np.full(canon, -2, np.int32)
            own[:qn] = rows
            dst = np.full(canon, n, np.int32)  # pad -> dropped by scatter
            dst[:qn] = rows
            dh, sh = block_topk(
                jnp.asarray(qc), vecs, sqn, prefix, inf, k, kind,
                super_tile=super_tile,
            )
            fs, fd = fin(
                corpus, sh, dh, jnp.asarray(own), min(m_forward, width), out_w,
            )
            rows_dev = jnp.asarray(dst)
            adj_s = _scatter_rows(adj_s, rows_dev, fs, width)
            adj_d = _scatter_rows(adj_d, rows_dev, fd, width)
        return adj_s, adj_d

    def finalize_rows(self, cand_s, cand_d, width):
        """Host-facing wrapper over the fused dedup/heuristic/select pass
        (tests + small callers). cand_s [B, C] global slots (SENT empty),
        cand_d [B, C]. Returns (slots [B, width] with -1, dists)."""
        import jax.numpy as jnp

        fin = _make_finalize(self.cosine)
        b, c = cand_s.shape
        bp, cp = _pow2(b), _pow2(c)
        sg = np.full((bp, cp), SENT, np.int32)
        dg = np.full((bp, cp), np.inf, np.float32)
        sg[:b, :c] = cand_s
        dg[:b, :c] = cand_d
        own = np.full(bp, -2, np.int32)
        ss, dd = fin(
            self._finalize_corpus(), jnp.asarray(sg), jnp.asarray(dg),
            jnp.asarray(own), width, width,
        )
        ss = np.asarray(ss)[:b]
        dd = np.asarray(dd)[:b]
        return np.where(ss == SENT, -1, ss), dd


def _scatter_rows(dst, rows, vals, width):
    """Row scatter with out-of-range rows dropped (stage padding)."""
    return dst.at[rows].set(vals[:, :width], mode="drop")


# -- fused device passes ------------------------------------------------------

_FINALIZE_CACHE: dict = {}
_APPEND_CACHE: dict = {}


def _finalize_math(corpus, cand_s, cand_d, own, select, out_width, cosine):
    """Traced core: self-strip, slot-dedup (keep min distance), (d, slot)
    ordering, pairwise bf16 distances, greedy relative-neighborhood
    admission, admitted-first selection with nearest backfill. Keeps the
    best `select` entries, padded to `out_width` columns (forward stages
    select m edges into 2m-wide rows)."""
    import jax.numpy as jnp
    from jax import lax

    B, C = cand_s.shape
    invalid = (cand_s == SENT) | (cand_s == own[:, None])
    d0 = jnp.where(invalid, jnp.inf, cand_d)
    s0 = jnp.where(invalid, SENT, cand_s)
    # dedup: (slot, d) sort makes duplicates adjacent with min-d first
    # (a forward edge and its reverse append can differ in the last float
    # bits, hence two-key sort rather than bit-equality)
    s1, d1 = lax.sort((s0, d0), dimension=1, num_keys=2)
    dup = jnp.concatenate(
        [
            jnp.zeros((B, 1), bool),
            (s1[:, 1:] == s1[:, :-1]) & (s1[:, 1:] != SENT),
        ],
        axis=1,
    )
    d1 = jnp.where(dup, jnp.inf, d1)
    s1 = jnp.where(dup, SENT, s1)
    # canonical (dist asc, slot asc) candidate order
    d2, s2 = lax.sort((d1, s1), dimension=1, num_keys=2)

    # pairwise candidate distances in bf16: the heuristic only compares
    # them, and an admission flipped by rounding changes which of two
    # near-equidistant neighbours is kept, not the graph's correctness
    cv = corpus[jnp.clip(s2, 0, len(corpus) - 1)].astype(jnp.bfloat16)
    ip = jnp.einsum("bpd,bqd->bpq", cv, cv, preferred_element_type=jnp.float32)
    if cosine:
        pair_d = 1.0 - jnp.clip(ip, -1.0, 1.0)
    else:
        sq = jnp.einsum("bpd,bpd->bp", cv, cv, preferred_element_type=jnp.float32)
        pair_d = jnp.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * ip, 0.0)
    valid = (s2 != SENT) & jnp.isfinite(d2)
    mind = jnp.full((B, C), jnp.inf, jnp.float32)
    cols = []
    for j in range(C):
        admit = (d2[:, j] < mind[:, j]) & valid[:, j]
        mind = jnp.where(admit[:, None], jnp.minimum(mind, pair_d[:, :, j]), mind)
        cols.append(admit)
    admitted = jnp.stack(cols, axis=1)

    # admitted first (their d-order = column order), then nearest
    # non-admitted backfill: stable 2-key sort on (not-admitted, position)
    notadm = (~admitted).astype(jnp.int32)
    pos = lax.broadcasted_iota(jnp.int32, (B, C), 1)
    _, _, s3, d3 = lax.sort((notadm, pos, s2, d2), dimension=1, num_keys=2)
    if C < select:
        s3 = jnp.pad(s3, ((0, 0), (0, select - C)), constant_values=SENT)
        d3 = jnp.pad(d3, ((0, 0), (0, select - C)), constant_values=jnp.inf)
    s3 = s3[:, :select]
    d3 = d3[:, :select]
    if select < out_width:
        s3 = jnp.pad(
            s3, ((0, 0), (0, out_width - select)), constant_values=SENT
        )
        d3 = jnp.pad(
            d3, ((0, 0), (0, out_width - select)), constant_values=jnp.inf
        )
    return s3, d3


def _make_finalize(cosine: bool):
    if cosine in _FINALIZE_CACHE:
        return _FINALIZE_CACHE[cosine]
    from functools import partial

    import jax

    @partial(jax.jit, static_argnames=("select", "out_width"))
    def fin(corpus, cand_s, cand_d, own, select: int, out_width: int):
        return _finalize_math(
            corpus, cand_s, cand_d, own, select, out_width, cosine
        )

    _FINALIZE_CACHE[cosine] = fin
    return fin


def _make_append(cosine: bool):
    """One jitted pass for the layer's reverse edges: edge flattening,
    (dst, d, src) sort, per-destination rank by prefix cummax, bounded
    scatter, then chunked re-selection of every row under lax.map (the
    [rows, C, C] pairwise stage bounds peak memory)."""
    if cosine in _APPEND_CACHE:
        return _APPEND_CACHE[cosine]
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import lax

    @partial(jax.jit, static_argnames=("width",), donate_argnums=(1, 2))
    def append(corpus, adj_s, adj_d, order_pad, width: int):
        n, w = adj_s.shape
        L = order_pad.shape[0]
        oc = jnp.minimum(order_pad, n - 1)
        is_pad = order_pad >= n
        fwd_s = jnp.where(is_pad[:, None], SENT, adj_s[oc])     # [L, w]
        fwd_d = jnp.where(is_pad[:, None], jnp.inf, adj_d[oc])
        src = jnp.broadcast_to(order_pad[:, None], (L, w))

        dst_f = fwd_s.reshape(-1)
        src_f = src.reshape(-1)
        d_f = fwd_d.reshape(-1)
        dst_f, d_f, src_f = lax.sort((dst_f, d_f, src_f), num_keys=3)

        e = dst_f.shape[0]
        iota = jnp.arange(e, dtype=jnp.int32)
        is_start = jnp.concatenate(
            [jnp.ones(1, bool), dst_f[1:] != dst_f[:-1]]
        )
        run_start = lax.cummax(jnp.where(is_start, iota, 0))
        rank = iota - run_start
        cap = 2 * width  # append pool: the heuristic can admit beyond the
        #                  nearest `width`, but a hub's in-degree tail never
        #                  survives selection
        keepm = (dst_f != SENT) & (rank < cap)
        row_idx = jnp.where(keepm, dst_f, n)
        col_idx = jnp.where(keepm, rank, 0)
        app_s = jnp.full((n + 1, cap), SENT, jnp.int32)
        app_d = jnp.full((n + 1, cap), jnp.inf, jnp.float32)
        app_s = app_s.at[row_idx, col_idx].set(
            jnp.where(keepm, src_f, SENT), mode="drop"
        )
        app_d = app_d.at[row_idx, col_idx].set(
            jnp.where(keepm, d_f, jnp.inf), mode="drop"
        )

        cand_s = jnp.concatenate([adj_s, app_s[:n]], axis=1)  # [n, w+cap]
        cand_d = jnp.concatenate([adj_d, app_d[:n]], axis=1)
        n_pad = -(-n // FIN_CHUNK) * FIN_CHUNK
        if n_pad > n:
            cand_s = jnp.pad(cand_s, ((0, n_pad - n), (0, 0)), constant_values=SENT)
            cand_d = jnp.pad(
                cand_d, ((0, n_pad - n), (0, 0)), constant_values=jnp.inf
            )
        c = cand_s.shape[1]
        own = jnp.full((FIN_CHUNK,), -2, jnp.int32)

        def body(args):
            cs, cd = args
            return _finalize_math(corpus, cs, cd, own, width, width, cosine)

        ss, _ = lax.map(
            body,
            (
                cand_s.reshape(-1, FIN_CHUNK, c),
                cand_d.reshape(-1, FIN_CHUNK, c),
            ),
        )
        ss = ss.reshape(n_pad, width)[:n]
        return jnp.where(ss == SENT, -1, ss)  # host-facing -1 padding

    _APPEND_CACHE[cosine] = append
    return append
