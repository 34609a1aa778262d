"""Streaming masked top-k over corpus tiles.

The reference scans all vectors and sorts on the host per query
(flat_index_search.go:254-291). Here the corpus lives in HBM as a padded
[N, d] array; we scan it in tiles with `lax.scan`, keep a running [Q, k]
result set, and never materialize the full [Q, N] distance matrix.

Determinism contract (needed for exact recall-parity tests): results are
ordered by ascending score, ties broken by ascending slot index. The merge
uses `lax.sort` with two keys (score, index) which is lexicographic, and
`lax.top_k` already prefers lower indices on ties.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from comet_tpu.types import DistanceKind
from comet_tpu.ops.distance import pairwise_scores_from_norms

INF = jnp.inf
IDX_SENTINEL = jnp.int32(2**31 - 1)


def merge_topk(
    scores_a: jax.Array,
    idx_a: jax.Array,
    scores_b: jax.Array,
    idx_b: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Merge two [Q, ka]/[Q, kb] top-k sets into the best [Q, k].

    Lower score is better; ties break toward the lower index. Used by the
    streaming scan, cross-segment merging, and cross-shard merging.
    """
    s = jnp.concatenate([scores_a, scores_b], axis=1)
    i = jnp.concatenate([idx_a, idx_b], axis=1)
    s_sorted, i_sorted = lax.sort((s, i), dimension=1, num_keys=2)
    return s_sorted[:, :k], i_sorted[:, :k]


def topk_lower(scores: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Top-k *smallest* scores per row with lowest-index tie-break."""
    neg, idx = lax.top_k(-scores, k)
    return -neg, idx


@partial(jax.jit, static_argnames=("k", "kind", "tile"))
def scan_topk(
    queries: jax.Array,
    corpus: jax.Array,
    corpus_sqnorms: jax.Array,
    valid: jax.Array,
    threshold: jax.Array,
    k: int,
    kind: DistanceKind,
    tile: int,
) -> tuple[jax.Array, jax.Array]:
    """Exact masked k-NN of `queries` against `corpus`.

    Args:
      queries: [Q, d] float32, preprocessed.
      corpus:  [N, d] float32, preprocessed, N % tile == 0 (padded capacity).
      corpus_sqnorms: [N] float32 precomputed squared norms (ignored for
        cosine).
      valid: [N] bool — validity mask (live rows & doc-ID filter fused).
      threshold: scalar float32; rows with distance > threshold are masked.
        Pass +inf to disable (reference semantics: threshold 0 = disabled,
        flat_index_search.go:269 — the host maps 0 to +inf).
      k: static result count per query (k <= tile required).
      kind: static distance metric.
      tile: static corpus tile size.

    Returns:
      (scores [Q, k] float32, slots [Q, k] int32). Empty result slots carry
      score=+inf and slot=IDX_SENTINEL.
    """
    Q = queries.shape[0]
    N = corpus.shape[0]
    assert N % tile == 0, (N, tile)
    num_tiles = N // tile

    init_scores = jnp.full((Q, k), INF, dtype=jnp.float32)
    init_idx = jnp.full((Q, k), IDX_SENTINEL, dtype=jnp.int32)

    if num_tiles == 1:
        return _tile_topk(
            queries, corpus, corpus_sqnorms, valid, threshold, 0,
            init_scores, init_idx, k, kind,
        )

    corpus_t = corpus.reshape(num_tiles, tile, -1)
    sqnorms_t = corpus_sqnorms.reshape(num_tiles, tile)
    valid_t = valid.reshape(num_tiles, tile)

    def body(carry, inp):
        best_s, best_i = carry
        tile_x, tile_n, tile_v, tile_idx = inp
        best = _tile_topk(
            queries, tile_x, tile_n, tile_v, threshold, tile_idx * tile,
            best_s, best_i, k, kind,
        )
        return best, None

    (scores, idx), _ = lax.scan(
        body,
        (init_scores, init_idx),
        (corpus_t, sqnorms_t, valid_t, jnp.arange(num_tiles, dtype=jnp.int32)),
    )
    return scores, idx


def block_select_from_dist(
    dist: jax.Array,  # [Q, ST] float32, already masked with +inf
    k: int,
    block: int,
    base,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k of a masked distance tile via contiguous block selection.

    See `block_topk` for the exactness argument. `base` is added to local
    indices to produce global slots; empty slots get (inf, IDX_SENTINEL).
    Returns ([Q, k] scores, [Q, k] slots).
    """
    Q, st = dist.shape
    G = st // block
    dist3 = dist.reshape(Q, G, block)
    gmin = jnp.min(dist3, axis=2)  # [Q, G]
    kb = min(k, G)
    _, sel = lax.top_k(-gmin, kb)  # ties -> lower group id
    gathered = jnp.take_along_axis(dist3, sel[:, :, None], axis=1)  # [Q, kb, B]
    gidx = sel[:, :, None] * block + lax.broadcasted_iota(
        jnp.int32, (Q, kb, block), 2
    )
    ss, ii = lax.sort(
        (gathered.reshape(Q, kb * block), gidx.reshape(Q, kb * block)),
        dimension=1,
        num_keys=2,
    )
    kk = min(k, kb * block)
    s_out = ss[:, :kk]
    i_out = jnp.where(s_out == INF, IDX_SENTINEL, ii[:, :kk] + base)
    if kk < k:
        s_out = jnp.pad(s_out, ((0, 0), (0, k - kk)), constant_values=INF)
        i_out = jnp.pad(i_out, ((0, 0), (0, k - kk)), constant_values=IDX_SENTINEL)
    return s_out, i_out


@partial(jax.jit, static_argnames=("k", "kind", "block", "super_tile"))
def block_topk(
    queries: jax.Array,
    corpus: jax.Array,
    corpus_sqnorms: jax.Array,
    valid: jax.Array,
    threshold: jax.Array,
    k: int,
    kind: DistanceKind,
    block: int = 128,
    super_tile: int = 1 << 20,
    scale: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact masked k-NN via two-level block selection (fast path).

    `scale` dequantizes an int8 `corpus` (symmetric abs-max storage;
    corpus_sqnorms must be dequantized-domain).

    Same contract as `scan_topk`, but ~6x cheaper selection: XLA's TopK costs
    ~O(k * N) per query; here the corpus is split into contiguous groups of
    `block` rows, a cheap VPU min-reduce produces per-group minima, and only
    the best min(k, n_groups) groups are gathered for the final small sort.

    Exactness (incl. tie order): every element with score <= tau* (the k-th
    best key) lives in a group whose min <= tau*, and at most k groups can
    contain such elements; with CONTIGUOUS groups, ordering groups by
    (min, group_id) is consistent with ordering elements by (score, index),
    so the gathered candidate superset always contains the true top-k in the
    deterministic (score asc, index asc) order.
    """
    Q = queries.shape[0]
    N = corpus.shape[0]
    assert N % min(super_tile, N) == 0
    st = min(super_tile, N)
    num_super = N // st

    def one_super(x_st, sqn_st, valid_st, base):
        dist = pairwise_scores_from_norms(
            queries, x_st, sqn_st, kind, scale=scale
        )  # [Q, st]
        mask = valid_st[None, :] & (dist <= threshold)
        dist = jnp.where(mask, dist, INF)
        return block_select_from_dist(dist, k, block, base)

    if num_super == 1:
        return one_super(corpus, corpus_sqnorms, valid, 0)

    xs = corpus.reshape(num_super, st, -1)
    ns = corpus_sqnorms.reshape(num_super, st)
    vs = valid.reshape(num_super, st)

    def body(carry, inp):
        bs, bi = carry
        x_st, sqn_st, valid_st, idx = inp
        s, i = one_super(x_st, sqn_st, valid_st, idx * st)
        return merge_topk(bs, bi, s, i, k), None

    init = (
        jnp.full((Q, k), INF, dtype=jnp.float32),
        jnp.full((Q, k), IDX_SENTINEL, dtype=jnp.int32),
    )
    (scores, idx), _ = lax.scan(
        body, init, (xs, ns, vs, jnp.arange(num_super, dtype=jnp.int32))
    )
    return scores, idx


def _tile_topk(queries, tile_x, tile_n, tile_v, threshold, base, best_s, best_i, k, kind):
    dist = pairwise_scores_from_norms(queries, tile_x, tile_n, kind)  # [Q, T]
    mask = tile_v[None, :] & (dist <= threshold)
    dist = jnp.where(mask, dist, INF)
    kk = min(k, tile_x.shape[0])
    s, i = topk_lower(dist, kk)
    gi = jnp.where(s == INF, IDX_SENTINEL, i + base).astype(jnp.int32)
    return merge_topk(best_s, best_i, s, gi, k)
