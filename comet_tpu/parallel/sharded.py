"""Corpus sharding across a device mesh.

The reference is a single Go process; its only "parallelism" is mutexes and
goroutines (SURVEY.md §2 checklist). Here the scaling axis is SPMD over a
1-D mesh of all devices (jax.sharding + shard_map); on a host of GPUs the
collectives run as NCCL over NVLink:

- Search: the corpus [N, d] is row-sharded over a 1-D mesh. Each device runs
  the same streaming masked top-k on its local shard, offsets local slot
  indices to global slots, then an `all_gather` of the per-shard [Q, k] (score,
  slot) pairs crosses the mesh and a two-key sort merges them — exactly the
  per-shard-top-k + gather/merge plan from SURVEY.md §5.8.
- K-means training: per-shard partial centroid sums/counts are combined with
  `psum` over the mesh, so IVF/PQ training scales to corpora that don't fit
  one device's memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from comet_tpu.ops.distance import (
    pairwise_scores,
    pairwise_scores_from_norms,
    preprocess,
)
from comet_tpu.ops.topk import IDX_SENTINEL, INF, merge_topk, scan_topk, topk_lower
from comet_tpu.types import DistanceKind

AXIS = "shard"


def make_corpus_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices; the corpus rows shard over it."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def padded_shard(n: int, n_dev: int, tile: int) -> tuple[int, int]:
    """(rows per device, scan tile) for n rows over n_dev devices: the
    shard is padded up to a multiple of the tile, so every device's tiled
    scan splits evenly (padding rows are invalid)."""
    shard = max(-(-n // n_dev), 1)
    tile = min(tile, shard)
    return -(-shard // tile) * tile, tile


def shard_rows(mesh: Mesh, *arrays):
    """Place arrays with their leading axis sharded over the mesh."""
    out = []
    for a in arrays:
        spec = P(AXIS) if a.ndim >= 1 else P()
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out) if len(out) > 1 else out[0]


def make_sharded_search(mesh: Mesh, k: int, kind: DistanceKind, tile: int):
    """Build a jitted sharded exact-search step.

    fn(queries [Q, d] replicated, corpus [N, d] row-sharded, sqnorms [N],
    valid [N], threshold scalar) -> (scores [Q, k], global_slots [Q, k]),
    replicated on every device.
    """

    def local(queries, corpus, sqnorms, valid, threshold):
        n_local = corpus.shape[0]
        s, i = scan_topk(queries, corpus, sqnorms, valid, threshold, k, kind, tile)
        base = lax.axis_index(AXIS).astype(jnp.int32) * n_local
        gi = jnp.where(i == IDX_SENTINEL, IDX_SENTINEL, i + base)
        # All-gather the tiny [Q, k] candidate sets over the mesh and merge.
        all_s = lax.all_gather(s, AXIS, axis=1, tiled=True)   # [Q, n_dev*k]
        all_i = lax.all_gather(gi, AXIS, axis=1, tiled=True)
        ss, ii = lax.sort((all_s, all_i), dimension=1, num_keys=2)
        return ss[:, :k], ii[:, :k]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_kmeans_step(mesh: Mesh, kind: DistanceKind):
    """Build a jitted distributed k-means step (assignment + psum'd update).

    fn(vectors [N, d] row-sharded, valid [N] row-sharded, prev_assign [N]
    row-sharded, centroids [k, d] replicated)
      -> (assign [N] sharded, new_centroids [k, d] replicated,
          changed scalar replicated)
    Empty clusters keep their previous centroid (clustering.go:236-238).
    """

    def local(vectors, valid, prev_assign, centroids):
        k = centroids.shape[0]
        dist = pairwise_scores(vectors, centroids, kind)
        assign = jnp.argmin(dist, axis=1).astype(jnp.int32)
        assign = jnp.where(valid, assign, k)
        w = valid.astype(jnp.float32)
        sums = jax.ops.segment_sum(vectors * w[:, None], assign, num_segments=k + 1)[:k]
        counts = jax.ops.segment_sum(w, assign, num_segments=k + 1)[:k]
        sums = lax.psum(sums, AXIS)
        counts = lax.psum(counts, AXIS)
        changed = lax.pmax(
            jnp.any((assign != prev_assign) & valid).astype(jnp.int32), AXIS
        )
        counts_col = counts[:, None]
        new_centroids = jnp.where(
            counts_col > 0, sums / jnp.maximum(counts_col, 1.0), centroids
        )
        return assign, new_centroids, changed

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_ivf_search(
    mesh: Mesh, k: int, kind: DistanceKind, nprobe: int, tile: int,
    coarse_kind: DistanceKind | None = None,
):
    """Build a jitted sharded IVF search step (SURVEY §5.8 / VERDICT r1 #8).

    Inverted lists are sharded BY ROW over the mesh (each device owns a
    contiguous row range of the corpus plus those rows' cluster
    assignments); centroids are replicated. Each device ranks centroids
    (replicated compute, ties to the lower centroid id — parity with
    `indexes/ivf._ivf_search_kernel`), builds a per-query probe-membership
    table, scans its local rows with probe membership fused into the
    distance mask (psum-free), and the per-shard [Q, k] candidates merge
    with one `all_gather` over the mesh — identical result contract to the
    single-device IVFIndex.

    fn(queries [Q, d] replicated (preprocessed), corpus [N, d] row-sharded,
       sqnorms [N], assign [N] int32 (-1 = invalid), valid [N] bool,
       centroids [nlist, d] replicated, threshold scalar)
      -> (scores [Q, k], global_slots [Q, k]) replicated.
    """

    ckind = coarse_kind if coarse_kind is not None else kind

    def local(queries, corpus, sqnorms, assign, valid, centroids, threshold):
        q = queries.shape[0]
        nlist = centroids.shape[0]
        n_local = corpus.shape[0]
        cd = pairwise_scores(queries, centroids, ckind)  # [Q, nlist]
        _, probes = lax.top_k(-cd, nprobe)               # ties -> lower id
        ptab = (
            jnp.zeros((q, nlist), bool)
            .at[jnp.arange(q)[:, None], probes]
            .set(True)
        )

        num_tiles = max(n_local // tile, 1)
        t = n_local // num_tiles
        xs = corpus.reshape(num_tiles, t, -1)
        ns = sqnorms.reshape(num_tiles, t)
        As = assign.reshape(num_tiles, t)
        vs = valid.reshape(num_tiles, t)

        def body(carry, inp):
            bs, bi = carry
            x, sq, a, v, t_idx = inp
            dist = pairwise_scores_from_norms(queries, x, sq, kind)  # [Q, t]
            member = ptab[:, jnp.maximum(a, 0)]                      # [Q, t]
            ok = member & (a >= 0)[None, :] & v[None, :] & (dist <= threshold)
            dist = jnp.where(ok, dist, INF)
            kk = min(k, t)
            s, i = topk_lower(dist, kk)
            gi = jnp.where(s == INF, IDX_SENTINEL, i + t_idx * t).astype(jnp.int32)
            return merge_topk(bs, bi, s, gi, k), None

        init = (
            jnp.full((q, k), INF, jnp.float32),
            jnp.full((q, k), IDX_SENTINEL, jnp.int32),
        )
        (s, i), _ = lax.scan(
            body, init, (xs, ns, As, vs, jnp.arange(num_tiles, dtype=jnp.int32))
        )
        base = lax.axis_index(AXIS).astype(jnp.int32) * n_local
        gi = jnp.where(i == IDX_SENTINEL, IDX_SENTINEL, i + base)
        all_s = lax.all_gather(s, AXIS, axis=1, tiled=True)
        all_i = lax.all_gather(gi, AXIS, axis=1, tiled=True)
        ss, ii = lax.sort((all_s, all_i), dimension=1, num_keys=2)
        return ss[:, :k], ii[:, :k]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedFlatSearcher:
    """Convenience wrapper: shard a corpus once, search many times.

    This is the multi-chip serving path for the flat index: corpus rows live
    sharded across the devices' memory; every search broadcasts the (small)
    query batch, runs per-shard scans in parallel, and merges k-candidates
    over the mesh.
    """

    def __init__(
        self,
        mesh: Mesh,
        corpus: np.ndarray,
        kind: DistanceKind = DistanceKind.L2,
        tile: int = 1 << 17,
    ):
        n_dev = mesh.devices.size
        n = corpus.shape[0]
        shard, tile = padded_shard(n, n_dev, tile)
        n_pad = shard * n_dev
        pad = np.zeros((n_pad, corpus.shape[1]), dtype=np.float32)
        pad[:n] = corpus
        valid = np.zeros(n_pad, dtype=bool)
        valid[:n] = True
        self.mesh = mesh
        self.kind = DistanceKind(kind)
        self.tile = tile
        self.n = n
        self.n_pad = n_pad
        self._valid_host = valid
        self.corpus, self.valid = shard_rows(mesh, pad, valid)
        self.sqnorms = shard_rows(mesh, (pad * pad).sum(axis=1).astype(np.float32))
        self._search_fns: dict[int, object] = {}

    def _valid_for(self, allowed: np.ndarray | None):
        """Per-call validity: base liveness AND an optional host keep-mask
        over the original n rows (the hybrid path's metadata candidates)."""
        if allowed is None:
            return self.valid
        mask = self._valid_host.copy()
        mask[: self.n] &= np.asarray(allowed[: self.n], dtype=bool)
        return shard_rows(self.mesh, mask)

    def search(self, queries: np.ndarray, k: int, allowed: np.ndarray | None = None):
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        queries = preprocess(queries, self.kind)
        fn = self._search_fns.get(k)
        if fn is None:
            fn = make_sharded_search(self.mesh, k, self.kind, self.tile)
            self._search_fns[k] = fn
        s, i = fn(
            jnp.asarray(queries), self.corpus, self.sqnorms,
            self._valid_for(allowed), jnp.asarray(np.float32(np.inf)),
        )
        return np.asarray(s), np.asarray(i)


class ShardedIVFSearcher:
    """Multi-chip IVF serving: inverted lists sharded by corpus row.

    Built from a TRAINED single-device `IVFIndex` (centroids + per-row
    cluster assignments come from it, so sharded results are oracle-exact
    vs the source index): rows + assignments shard over the mesh, centroids
    replicate, and every search runs the per-shard probe-masked scan +
    all_gather merge from `make_sharded_ivf_search`.
    """

    def __init__(self, mesh: Mesh, ivf_index, tile: int = 1 << 14):
        from comet_tpu.indexes.ivf import IVFIndex

        assert isinstance(ivf_index, IVFIndex) and ivf_index.trained
        store = ivf_index._store
        n = store.n
        shard, tile = padded_shard(n, mesh.devices.size, tile)
        n_pad = shard * mesh.devices.size
        dim = store.vectors.shape[1]
        pad = np.zeros((n_pad, dim), dtype=np.float32)
        pad[:n] = store.vectors[:n]
        assign = np.full(n_pad, -1, dtype=np.int32)
        assign[:n] = ivf_index._assign[:n]
        valid = np.zeros(n_pad, dtype=bool)
        valid[:n] = store.valid[:n]
        self.mesh = mesh
        self.kind = ivf_index.distance_kind()
        self.n = n
        self.n_pad = n_pad
        self.tile = tile
        self.row_ids = store.ids[:n].copy()
        self.centroids = jnp.asarray(ivf_index._centroids)
        self._valid_host = valid
        self.corpus, self.assign, self.valid = shard_rows(mesh, pad, assign, valid)
        self.sqnorms = shard_rows(mesh, (pad * pad).sum(axis=1).astype(np.float32))
        self._search_fns: dict[tuple[int, int], object] = {}

    def _valid_for(self, allowed: np.ndarray | None):
        if allowed is None:
            return self.valid
        mask = self._valid_host.copy()
        mask[: self.n] &= np.asarray(allowed[: self.n], dtype=bool)
        return shard_rows(self.mesh, mask)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        nprobe: int | None = None,
        allowed: np.ndarray | None = None,
    ):
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        queries = preprocess(queries, self.kind)
        nlist = self.centroids.shape[0]
        nprobe = int(nprobe) if nprobe else max(int(round(nlist**0.5)), 1)
        nprobe = min(nprobe, nlist)
        fn = self._search_fns.get((k, nprobe))
        if fn is None:
            fn = make_sharded_ivf_search(self.mesh, k, self.kind, nprobe, self.tile)
            self._search_fns[(k, nprobe)] = fn
        s, i = fn(
            jnp.asarray(queries), self.corpus, self.sqnorms, self.assign,
            self._valid_for(allowed), self.centroids,
            jnp.asarray(np.float32(np.inf)),
        )
        return np.asarray(s), np.asarray(i)


class ShardedPQSearcher:
    """Multi-chip PQ serving: decoded reconstructions sharded over the mesh.

    ADC distance is exactly L2 to the PQ reconstruction (the sum over
    subspaces of |q_m - codebook[m, code_m]|^2 IS |q - decode(code)|^2;
    pq_index_search.go:243-306 is the scalar-LUT equivalent), so sharded
    PQ search IS a sharded flat L2 scan
    over the decoded corpus — codes stay the authoritative storage; the
    reconstruction is a per-shard search-time cache. Queries are
    preprocessed for the SOURCE index's metric (cosine normalizes), then
    scanned with sqrt-L2 like the single-device PQ path.
    """

    def __init__(self, mesh: Mesh, pq_index, tile: int = 1 << 14):
        from comet_tpu.indexes.pq import PQIndex
        from comet_tpu.ops.adc import pq_decode

        assert isinstance(pq_index, PQIndex) and pq_index.trained
        store = pq_index._store
        n = store.n
        rec = np.array(
            pq_decode(
                jnp.asarray(pq_index._codes[:n]),
                jnp.asarray(pq_index._codebooks),
            )
        )
        if pq_index._rot is not None:
            rec = rec @ pq_index._rot.T  # OPQ: back to user coordinates
        rec[~store.valid[:n]] = 0.0
        self._flat = ShardedFlatSearcher(mesh, rec, DistanceKind.L2, tile)
        self._flat._valid_host[:n] = store.valid[:n]
        self._flat.valid = shard_rows(mesh, self._flat._valid_host)
        self._query_kind = pq_index.distance_kind()
        self.n = n
        self.row_ids = store.ids[:n].copy()

    def search(self, queries: np.ndarray, k: int, allowed: np.ndarray | None = None):
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        queries = preprocess(queries, self._query_kind)
        return self._flat.search(queries, k, allowed=allowed)


class ShardedIVFPQSearcher:
    """Multi-chip IVFPQ serving: reconstructed rows + assignments sharded,
    centroids/codebooks replicated.

    Same reconstruction identity as `ShardedPQSearcher`; the coarse probe
    ranks centroids with the source index's metric while the fine scan runs
    sqrt-L2 over reconstructions — the sharded twin of the single-device
    dense path (`IVFPQIndex._search_launch` use_dense), merged with one
    `all_gather` over the mesh.
    """

    def __init__(self, mesh: Mesh, ivfpq_index, tile: int = 1 << 14):
        from comet_tpu.indexes.ivfpq import IVFPQIndex
        from comet_tpu.ops.adc import pq_decode

        assert isinstance(ivfpq_index, IVFPQIndex) and ivfpq_index.trained
        store = ivfpq_index._store
        n = store.n
        n_dev = mesh.devices.size
        assign_np = ivfpq_index._assign[:n].astype(np.int32)
        rec = np.asarray(
            pq_decode(
                jnp.asarray(ivfpq_index._codes[:n]),
                jnp.asarray(ivfpq_index._codebooks),
            )
        ) + ivfpq_index._centroids[np.maximum(assign_np, 0)]
        centroids_np = ivfpq_index._centroids
        if ivfpq_index._rot is not None:
            # OPQ: model lives in rotated coordinates; rotate the
            # reconstructions and coarse centroids BACK once so the
            # sharded scan serves user-space queries
            rec = rec @ ivfpq_index._rot.T
            centroids_np = centroids_np @ ivfpq_index._rot.T
        shard, tile = padded_shard(n, n_dev, tile)
        n_pad = shard * n_dev
        dim = rec.shape[1]
        pad = np.zeros((n_pad, dim), dtype=np.float32)
        pad[:n] = rec
        assign = np.full(n_pad, -1, dtype=np.int32)
        assign[:n] = assign_np
        valid = np.zeros(n_pad, dtype=bool)
        valid[:n] = store.valid[:n]
        pad[~valid] = 0.0
        self.mesh = mesh
        self.kind = DistanceKind.L2          # fine scan over reconstructions
        self._coarse_kind = ivfpq_index.distance_kind()
        self._query_kind = ivfpq_index.distance_kind()
        self.n = n
        self.n_pad = n_pad
        self.tile = tile
        self.row_ids = store.ids[:n].copy()
        self.centroids = jnp.asarray(centroids_np)
        self._valid_host = valid
        self.corpus, self.assign, self.valid = shard_rows(mesh, pad, assign, valid)
        self.sqnorms = shard_rows(mesh, (pad * pad).sum(axis=1).astype(np.float32))
        self._search_fns: dict[tuple[int, int], object] = {}

    def _valid_for(self, allowed: np.ndarray | None):
        if allowed is None:
            return self.valid
        mask = self._valid_host.copy()
        mask[: self.n] &= np.asarray(allowed[: self.n], dtype=bool)
        return shard_rows(self.mesh, mask)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        nprobe: int | None = None,
        allowed: np.ndarray | None = None,
    ):
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        queries = preprocess(queries, self._query_kind)
        nlist = self.centroids.shape[0]
        nprobe = int(nprobe) if nprobe else max(int(round(nlist**0.5)), 1)
        nprobe = min(nprobe, nlist)
        fn = self._search_fns.get((k, nprobe))
        if fn is None:
            fn = make_sharded_ivf_search(
                self.mesh, k, self.kind, nprobe, self.tile,
                coarse_kind=self._coarse_kind,
            )
            self._search_fns[(k, nprobe)] = fn
        s, i = fn(
            jnp.asarray(queries), self.corpus, self.sqnorms, self.assign,
            self._valid_for(allowed), self.centroids,
            jnp.asarray(np.float32(np.inf)),
        )
        return np.asarray(s), np.asarray(i)


class ShardedHybridSearcher:
    """Multi-chip hybrid serving: metadata prefilter -> SHARDED vector scan
    -> text scoring -> fusion, with `HybridSearchIndex.search_batch`-
    identical result semantics (shared `fuse_batch_rows`).

    The vector corpus is the sharded modality (a ShardedFlatSearcher or
    ShardedIVFSearcher over rows whose doc ids are `row_ids`); the metadata
    candidate bitset compiles on host into a per-row keep-mask fused into
    every shard's scan (the packed-bitset handoff from hybrid.py, sharded);
    BM25 scores on the host/native path. The per-query merge is exactly
    `fuse_batch_rows`, so sharded hybrid results match the single-device
    coordinator bit-for-bit.
    """

    def __init__(
        self,
        vector_searcher,
        row_ids: np.ndarray,
        text_index=None,
        metadata_index=None,
    ):
        self._vector = vector_searcher
        self._row_ids = np.asarray(row_ids, dtype=np.uint32)
        assert len(self._row_ids) == vector_searcher.n
        self._text = text_index
        self._metadata = metadata_index

    def search_batch(
        self,
        vectors: np.ndarray | None = None,
        texts: "list[str] | None" = None,
        k: int = 10,
        *,
        metadata_filters=None,
        metadata_groups=None,
        fusion=None,
        fusion_kind=None,
        nprobes: int | None = None,
        cutoff: int = -1,
    ):
        from comet_tpu.core.filter import DocumentFilter
        from comet_tpu.fusion import default_fusion, new_fusion
        from comet_tpu.hybrid import fuse_batch_rows
        from comet_tpu.indexes.base import INVALID_ID, postprocess_batch_rows

        if vectors is not None:
            vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        nq = (
            len(vectors) if vectors is not None
            else len(texts) if texts is not None else 0
        )
        if nq == 0:
            return []
        fus = fusion or (
            new_fusion(fusion_kind) if fusion_kind is not None else default_fusion()
        )

        candidates = None
        if metadata_filters or metadata_groups:
            if self._metadata is None:
                raise ValueError("metadata filters but no metadata index")
            candidates = self._metadata.filter_bitset(
                metadata_filters or [], metadata_groups or []
            )
            if candidates.is_empty():
                return [[] for _ in range(nq)]

        v_ids = v_sc = None
        if vectors is not None:
            allowed = (
                DocumentFilter(candidates).slot_mask(self._row_ids)
                if candidates is not None else None
            )
            kw = (
                {"nprobe": nprobes}
                if nprobes
                and isinstance(
                    self._vector, (ShardedIVFSearcher, ShardedIVFPQSearcher)
                )
                else {}
            )
            v_sc, v_slots = self._vector.search(vectors, k, allowed=allowed, **kw)
            hit = v_slots != int(IDX_SENTINEL)
            v_ids = np.where(
                hit, self._row_ids[np.where(hit, v_slots, 0)], INVALID_ID
            ).astype(np.uint32)
            if cutoff != -1:
                v_ids, v_sc = postprocess_batch_rows(
                    v_ids[:, :k], np.asarray(v_sc)[:, :k], k, cutoff=cutoff,
                    ascending=True,
                )

        t_ids = t_sc = None
        if texts is not None:
            if self._text is None:
                raise ValueError("text queries but no text index")
            t_ids, t_sc = self._text.search_batch(
                texts, k=k, document_ids=candidates, cutoff=cutoff
            )

        return fuse_batch_rows(v_ids, v_sc, t_ids, t_sc, candidates, fus, nq, k)


def make_sharded_seeded_hnsw_search(
    mesh: Mesh, ef: int, k: int, kind: DistanceKind, max_iters: int,
    expand: int, fused: bool, stop: int,
):
    """Build the query-sharded SEEDED beam step (stage 2 of
    `ShardedSeededHNSWSearcher`): graph tables replicate, queries and their
    per-query seed blocks shard over the mesh, and each device runs the
    pure-XLA lockstep beam initialized from its queries' seeds with the
    k-window stop bound (the single-device seeded beam's termination,
    indexes/hnsw._search_launch). No collective: results stay sharded with
    their queries."""
    from comet_tpu.ops.graph import beam_search_layer0

    def local(queries, seeds_d, seeds_s, entries, adj, vectors, sqnorms,
              allowed, threshold):
        return beam_search_layer0(
            queries, entries, adj, vectors, sqnorms, allowed, threshold,
            ef, k, kind, max_iters, expand, fused,
            seed_d=seeds_d, seed_s=seeds_s, stop=stop,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P(), P(), P(), P(),
        ),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedSeededHNSWSearcher:
    """Multi-chip SEEDED-HNSW serving: a two-stage SPMD pipeline.

    Stage 1 (corpus-sharded) — the seed probe scan IS the sharded IVF
    search: the corpus rows + their ~sqrt(n)-cell k-means assignments shard
    over the mesh, each device scans its shard masked to the probed cells,
    and one [Q, stop] `all_gather` merges seed candidates over the mesh
    (`make_sharded_ivf_search`: the single-device seeded beam's
    cluster-probe start, indexes/hnsw._seed_scan, as a masked scan).

    Stage 2 (query-sharded) — the replicated-graph lockstep beam starts
    from each query's seed row with the k-window stop bound; queries and
    their seeds reshard from replicated to query-sharded between the
    stages (the [Q, stop] seed block is tiny — that reshard is the only
    cross-stage traffic).

    This layout suits both halves: the probe scan's big
    axis is the corpus (shard it), the graph walk's big axis is the query
    stream (shard that; graph tables are MBs and replicate). Seed distances
    ride the index's metric domain (ops/distance), so they merge cleanly
    with beam rediscovery distances, and results are shard-count-invariant
    (tests/test_seeded_beam.py::test_sharded_seeded_shard_count_invariance)."""

    def __init__(self, mesh: Mesh, hnsw_index, nlist: int | None = None,
                 nprobe: int = 0, tile: int = 1 << 13, seed: int = 0,
                 centroids: np.ndarray | None = None):
        from comet_tpu.indexes.base import next_pow2
        from comet_tpu.indexes.hnsw import SEARCH_EXPAND
        from comet_tpu.ops.kmeans import find_nearest_centroid, kmeans

        self._mesh = mesh
        self._idx = hnsw_index
        self._expand = SEARCH_EXPAND
        store = hnsw_index._store
        n = store.n
        rep = NamedSharding(mesh, P())
        # replicated graph state (same layout as ShardedHNSWSearcher)
        self._adj = jax.device_put(jnp.asarray(hnsw_index._adj0), rep)
        self._vectors = jax.device_put(jnp.asarray(store.vectors), rep)
        self._sqnorms = jnp.sum(self._vectors * self._vectors, axis=1)

        # seed centroids: caller-provided > the index's warm state (single-
        # device serving trains them lazily) > train here
        if centroids is not None:
            cents = np.asarray(centroids, dtype=np.float32)
        elif getattr(hnsw_index, "_seed_centroids", None) is not None and (
            nlist is None or len(hnsw_index._seed_centroids) == nlist
        ):
            cents = np.asarray(hnsw_index._seed_centroids)
        else:
            nl = nlist or max(64, min(4096, next_pow2(max(int(n**0.5), 1))))
            nl = min(nl, max(n, 1))
            sample = store.vectors[:n]
            if n > (1 << 17):
                sel = np.random.default_rng(seed).choice(
                    n, 1 << 17, replace=False
                )
                sample = sample[np.sort(sel)]
            cents, _ = kmeans(
                sample, nl, DistanceKind.L2_SQUARED, 10, return_assign=False
            )
            cents = np.asarray(cents)
        self._nlist = len(cents)
        self._nprobe_default = int(nprobe) or max(2, self._nlist // 64)

        # per-row cell assignments for the stage-1 probe scan
        assign_np = np.full(n, -1, np.int32)
        live = np.flatnonzero(store.valid[:n])
        ch = 1 << 18
        for i0 in range(0, len(live), ch):
            sl = live[i0 : i0 + ch]
            assign_np[sl] = np.asarray(
                find_nearest_centroid(store.vectors[sl], cents)
            )

        # corpus-sharded stage-1 state (rows pad to the mesh, like
        # ShardedIVFSearcher)
        n_dev = mesh.devices.size
        shard, tile = padded_shard(n, n_dev, tile)
        n_pad = shard * n_dev
        dim = store.vectors.shape[1]
        pad = np.zeros((n_pad, dim), np.float32)
        pad[:n] = store.vectors[:n]
        assign = np.full(n_pad, -1, np.int32)
        assign[:n] = assign_np
        valid = np.zeros(n_pad, bool)
        valid[:n] = store.valid[:n]
        self.n = n
        self._tile = tile
        self._centroids = jnp.asarray(cents)
        self._scan_corpus, self._scan_assign, self._scan_valid = shard_rows(
            mesh, pad, assign, valid
        )
        self._scan_sqnorms = shard_rows(
            mesh, (pad * pad).sum(axis=1).astype(np.float32)
        )
        self._seed_fns: dict = {}
        self._beam_fns: dict = {}

    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef_search: int | None = None,
        allowed: np.ndarray | None = None,
        threshold: float = 0.0,
        nprobe: int | None = None,
        seed_stop: int = 0,
    ):
        """Returns (scores [Q, k], slots [Q, k]); empty = (inf, SENTINEL)."""
        from comet_tpu.core.limiter import sanitize_k
        from comet_tpu.indexes.base import (
            next_pow2,
            pad_queries,
            threshold_scalar,
        )
        from comet_tpu.ops.distance import preprocess

        idx = self._idx
        n_dev = self._mesh.devices.size
        k_eff = sanitize_k(k, idx._store.n)
        ef = max(idx._effective_ef(ef_search), k_eff)
        k_pad = min(next_pow2(k_eff), idx._store.capacity)
        ef_pad = next_pow2(ef, 16)
        stop = min(seed_stop or max(2 * k_pad, 64), ef_pad)
        nprobe = int(nprobe) if nprobe else self._nprobe_default
        nprobe = min(nprobe, self._nlist)

        qprep = preprocess(
            np.atleast_2d(np.asarray(queries, dtype=np.float32)),
            idx._distance_kind,
        )
        q_real = len(qprep)
        qpad, _ = pad_queries(qprep)
        if len(qpad) % n_dev:
            grown = np.zeros(
                (-(-len(qpad) // n_dev) * n_dev, qpad.shape[1]), np.float32
            )
            grown[: len(qpad)] = qpad
            qpad = grown
        qdev = jnp.asarray(qpad)

        # stage 1: corpus-sharded probe scan -> [Q, stop] seed candidates
        skey = (stop, nprobe)
        if skey not in self._seed_fns:
            self._seed_fns[skey] = make_sharded_ivf_search(
                self._mesh, stop, idx._distance_kind, nprobe, self._tile
            )
        seed_d, seed_s = self._seed_fns[skey](
            qdev, self._scan_corpus, self._scan_sqnorms, self._scan_assign,
            self._scan_valid, self._centroids,
            jnp.asarray(np.float32(np.inf)),
        )

        # stage 2: query-sharded seeded beam over the replicated graph
        amask = jnp.asarray(idx._store.valid)
        if allowed is not None:
            amask = jnp.logical_and(amask, jnp.asarray(allowed))
        amask = jax.device_put(amask, NamedSharding(self._mesh, P()))
        fused = (
            allowed is not None or threshold > 0 or idx._store.deleted > 0
        )
        entries = np.full(len(qpad), max(idx._entry_slot, 0), np.int32)
        bkey = (ef_pad, k_pad, fused, stop)
        if bkey not in self._beam_fns:
            self._beam_fns[bkey] = make_sharded_seeded_hnsw_search(
                self._mesh, ef_pad, k_pad, idx._distance_kind,
                (2 * stop) // self._expand + 16, self._expand, fused, stop,
            )
        s, i = self._beam_fns[bkey](
            qdev, seed_d, seed_s, jnp.asarray(entries),
            self._adj, self._vectors, self._sqnorms, amask,
            threshold_scalar(threshold),
        )
        s, i = np.asarray(s), np.asarray(i)
        return s[:q_real, :k_eff], i[:q_real, :k_eff]


def make_sharded_hnsw_search(
    mesh: Mesh, ef: int, k: int, kind: DistanceKind, max_iters: int,
    expand: int, fused: bool,
):
    """Build a jitted QUERY-sharded HNSW beam step: the graph (adjacency +
    vectors) replicates on every device, the query batch shards over the
    mesh, and each device runs the full lockstep beam on its slice — the
    classic replicate-small-state / shard-big-batch serving layout (graph
    tables are MBs; the query stream is the unbounded axis). No collective
    is needed: results stay sharded with their queries."""
    from comet_tpu.ops.graph import beam_search_layer0

    def local(queries, entries, adj, vectors, sqnorms, allowed, threshold):
        return beam_search_layer0(
            queries, entries, adj, vectors, sqnorms, allowed, threshold,
            ef, k, kind, max_iters, expand, fused,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedHNSWSearcher:
    """Multi-chip HNSW serving: graph replicated, queries sharded.

    Mirrors HNSWIndex._search_batch parameters exactly (same beam kernel,
    same ef/k padding and iteration budget), so sharded results match the
    single-device index's unseeded beam bit-for-bit. Entry selection is the
    single-device nearest-upper-member matmul; the layer-0 beam — all the
    FLOPs — runs SPMD over the mesh.
    """

    def __init__(self, mesh: Mesh, hnsw_index):
        from comet_tpu.indexes.hnsw import SEARCH_EXPAND

        self._mesh = mesh
        self._idx = hnsw_index
        self._expand = SEARCH_EXPAND
        rep = NamedSharding(mesh, P())
        self._adj = jax.device_put(jnp.asarray(hnsw_index._adj0), rep)
        self._vectors = jax.device_put(
            jnp.asarray(hnsw_index._store.vectors), rep
        )
        self._sqnorms = jnp.sum(self._vectors * self._vectors, axis=1)
        self._valid = jax.device_put(
            jnp.asarray(hnsw_index._store.valid), rep
        )
        self._fns: dict = {}

    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef_search: int | None = None,
        allowed: np.ndarray | None = None,
        threshold: float = 0.0,
    ):
        """Returns (scores [Q, k], slots [Q, k]); empty = (inf, SENTINEL)."""
        from comet_tpu.indexes.base import (
            next_pow2,
            pad_queries,
            threshold_scalar,
        )
        from comet_tpu.core.limiter import sanitize_k
        from comet_tpu.ops.distance import preprocess

        idx = self._idx
        n_dev = self._mesh.devices.size
        k_eff = sanitize_k(k, idx._store.n)
        ef = max(idx._effective_ef(ef_search), k_eff)
        k_pad = min(next_pow2(k_eff), idx._store.capacity)
        ef_pad = next_pow2(ef, 16)

        qprep = preprocess(
            np.atleast_2d(np.asarray(queries, dtype=np.float32)),
            idx._distance_kind,
        )
        q_real = len(qprep)
        # pad the query batch to a multiple of the mesh size
        q_pad = -(-q_real // n_dev) * n_dev
        qpad, _ = pad_queries(qprep)
        if len(qpad) % n_dev:
            q_pad = -(-len(qpad) // n_dev) * n_dev
            grown = np.zeros((q_pad, qpad.shape[1]), np.float32)
            grown[: len(qpad)] = qpad
            qpad = grown
        entries = idx._descend_for_search(qpad)

        amask = jnp.asarray(idx._store.valid)
        if allowed is not None:
            amask = jnp.logical_and(amask, jnp.asarray(allowed))
        amask = jax.device_put(amask, NamedSharding(self._mesh, P()))
        fused = (
            allowed is not None or threshold > 0 or idx._store.deleted > 0
        )
        key = (ef_pad, k_pad, fused)
        if key not in self._fns:
            self._fns[key] = make_sharded_hnsw_search(
                self._mesh, ef_pad, k_pad, idx._distance_kind,
                (4 * ef_pad + 32) // self._expand + 16, self._expand, fused,
            )
        s, i = self._fns[key](
            jnp.asarray(qpad), jnp.asarray(entries),
            self._adj, self._vectors, self._sqnorms, amask,
            threshold_scalar(threshold),
        )
        s, i = np.asarray(s), np.asarray(i)
        return s[:q_real, :k_eff], i[:q_real, :k_eff]
