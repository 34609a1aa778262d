"""Batched graph-traversal kernels for HNSW.

The reference's HNSW search is per-query pointer chasing with Go heaps
(hnsw_index.go:565-629). Here layer-0 search is a LOCKSTEP BEAM: a whole
batch of queries runs best-first search simultaneously inside one XLA
while_loop — each iteration expands every query's best `expand` unexpanded
candidates, gathers their padded neighbor rows, scores all neighbors as one
batched matvec, and merges via two-key sorts. Per-query visited sets are packed
uint32 bitmasks; filter/threshold masks gate RESULT admission only, so filtered
nodes still route traversal (the reference post-filters AFTER traversal and can
return < k results, hnsw_index_search.go:308-335 — fixed here by design).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from comet_tpu.ops.distance import DEFAULT_PRECISION
from comet_tpu.ops.topk import IDX_SENTINEL, INF, merge_topk
from comet_tpu.types import DistanceKind


def _neighbor_dists(queries, qn, vectors, sqnorms, neigh, kind):
    """Distances from each query to its own neighbor row: [Q, W]."""
    nc = jnp.maximum(neigh, 0)
    vecs = vectors[nc]                      # [Q, W, d]
    ip = jnp.einsum(
        "qd,qwd->qw", queries, vecs,
        preferred_element_type=jnp.float32, precision=DEFAULT_PRECISION,
    )
    if kind == DistanceKind.COSINE:
        return 1.0 - jnp.clip(ip, -1.0, 1.0)
    dist = jnp.maximum(qn + sqnorms[nc] - 2.0 * ip, 0.0)
    if kind == DistanceKind.L2:
        dist = jnp.sqrt(dist)
    return dist


@partial(
    jax.jit,
    static_argnames=(
        "ef", "k", "kind", "max_iters", "expand", "fused_results", "stop"
    ),
)
def beam_search_layer0(
    queries: jax.Array,      # [Q, d] preprocessed
    entry_slots: jax.Array,  # [Q] int32 entry points (layer-0 slots)
    adj: jax.Array,          # [cap, W] int32 neighbor rows, -1 padded
    vectors: jax.Array,      # [cap, d]
    sqnorms: jax.Array,      # [cap]
    allowed: jax.Array,      # [cap] bool — result-admission mask
    threshold: jax.Array,    # scalar f32 (+inf to disable)
    ef: int,
    k: int,
    kind: DistanceKind,
    max_iters: int,
    expand: int = 1,
    fused_results: bool = True,
    seed_d: jax.Array | None = None,  # [Q, ef] f32 metric-space distances
    seed_s: jax.Array | None = None,  # [Q, ef] i32 slots, (INF, SENT) padded
    stop: int | None = None,
):
    """Lockstep ef-beam search. Returns (res_d [Q,k], res_s [Q,k]) sorted
    ascending with (score, slot) tie-break; empty slots are
    (inf, IDX_SENTINEL).

    `expand` > 1 expands that many best unexpanded candidates per iteration
    (the sequential while_loop is the wall-clock bottleneck, so trade a
    slightly different exploration order for ~expand x fewer iterations;
    recall impact is negligible at these ef).

    `fused_results=True` merges every ALLOWED scored node into a separate
    result set each iteration — needed when filters/thresholds/deletes make
    result admission differ from beam membership. With `fused_results=False`
    the results are simply the best k of the final beam (exact whenever the
    admission mask accepts everything the beam holds, i.e. unfiltered
    searches and graph construction) and the loop runs one sort per
    iteration instead of two.

    `seed_d`/`seed_s` initialize the beam from an IVF cluster-probe scan
    (indexes/hnsw._seed_scan): rows must be sorted (dist, slot) ascending with
    (INF, IDX_SENTINEL) padding and duplicate-free per row; distances must live
    in the index's METRIC space (the same domain `_neighbor_dists` produces)
    since they flow into the returned results. Queries whose seed row is empty
    fall back to `entry_slots`. `stop` narrows the termination window: a query
    stays active while its best unexpanded candidate beats the stop-th beam
    entry (default ef — the classic bound); seeds fill the beam with true
    near-neighbors, so the classic bound would expand ALL of them while a
    k-sized window stops once expansion cannot change the returned top-k."""
    Q, d = queries.shape
    cap, W = adj.shape
    qn = jnp.sum(queries * queries, axis=1, keepdims=True)  # [Q,1]
    rows = jnp.arange(Q)

    # entry distances
    e_d = _neighbor_dists(queries, qn, vectors, sqnorms, entry_slots[:, None], kind)[:, 0]

    # Visited sets as PACKED uint32 bitmasks [Q, cap/32]: the loop-carried
    # state stays tiny so XLA's while-loop buffer churn is cheap. Marking
    # uses scatter-ADD, which is a safe OR here: bits are only added for
    # FRESH (unset) neighbors and adjacency rows are duplicate-free.
    n_words = cap // 32

    if seed_s is not None:
        sw = seed_s.shape[1]
        if sw > ef:  # sorted ascending: slicing keeps the best seeds
            seed_d, seed_s = seed_d[:, :ef], seed_s[:, :ef]
        elif sw < ef:
            seed_d = jnp.concatenate(
                [seed_d, jnp.full((Q, ef - sw), INF, jnp.float32)], axis=1
            )
            seed_s = jnp.concatenate(
                [seed_s, jnp.full((Q, ef - sw), IDX_SENTINEL, jnp.int32)],
                axis=1,
            )
        seeded_rows = seed_s[:, 0] != IDX_SENTINEL      # [Q]
        # entry fallback where the probe scan returned nothing
        cand_d = seed_d.at[:, 0].set(
            jnp.where(seeded_rows, seed_d[:, 0], e_d)
        )
        cand_s = seed_s.at[:, 0].set(
            jnp.where(seeded_rows, seed_s[:, 0], entry_slots)
        )
        live = cand_s != IDX_SENTINEL
        sc = jnp.maximum(cand_s, 0)
        visited = jnp.zeros((Q, n_words), jnp.uint32).at[
            rows[:, None], sc >> 5
        ].add(
            jnp.where(
                live,
                jnp.uint32(1) << (sc & 31).astype(jnp.uint32),
                jnp.uint32(0),
            )
        )
        ok0 = live & allowed[sc] & (cand_d <= threshold)
        rd0 = jnp.where(ok0, cand_d, INF)
        rs0 = jnp.where(ok0, cand_s, IDX_SENTINEL)
        sd0, ss0 = lax.sort((rd0, rs0), dimension=1, num_keys=2)
        res_d, res_s = sd0[:, :k], ss0[:, :k]
        if k > ef:  # pragma: no cover — callers keep k <= ef
            pad = jnp.full((Q, k - ef), INF, jnp.float32)
            res_d = jnp.concatenate([sd0, pad], axis=1)
            res_s = jnp.concatenate(
                [ss0, jnp.full((Q, k - ef), IDX_SENTINEL, jnp.int32)], axis=1
            )
    else:
        cand_d = jnp.full((Q, ef), INF, jnp.float32).at[:, 0].set(e_d)
        cand_s = jnp.full((Q, ef), IDX_SENTINEL, jnp.int32).at[:, 0].set(entry_slots)
        visited = jnp.zeros((Q, n_words), jnp.uint32).at[
            rows, entry_slots >> 5
        ].add(jnp.uint32(1) << (entry_slots & 31).astype(jnp.uint32))
        res_d = jnp.full((Q, k), INF, jnp.float32)
        res_s = jnp.full((Q, k), IDX_SENTINEL, jnp.int32)
        ok0 = allowed[entry_slots] & (e_d <= threshold)
        res_d = res_d.at[:, 0].set(jnp.where(ok0, e_d, INF))
        res_s = res_s.at[:, 0].set(jnp.where(ok0, entry_slots, IDX_SENTINEL))
    expanded = jnp.zeros((Q, ef), jnp.bool_)

    stop_col = ef - 1 if stop is None else min(max(int(stop), 1), ef) - 1

    def cond(state):
        i, cand_d, cand_s, expanded, visited, res_d, res_s, alive = state
        return (i < max_iters) & alive

    def body(state):
        i, cand_d, cand_s, expanded, visited, res_d, res_s, _ = state

        unexp_d = jnp.where(expanded | (cand_s == IDX_SENTINEL), INF, cand_d)
        worst = cand_d[:, stop_col]
        if expand == 1:
            best_pos = jnp.argmin(unexp_d, axis=1)[:, None]   # [Q, 1]
        else:
            _, best_pos = lax.top_k(-unexp_d, expand)         # [Q, E]
        best_d = jnp.take_along_axis(unexp_d, best_pos, axis=1)  # [Q, E]
        # a query is active while its BEST unexpanded beats the beam's worst
        active = (best_d[:, 0] < INF) & (best_d[:, 0] <= worst)
        do_expand = active[:, None] & (best_d < INF)          # [Q, E]

        expanded = expanded.at[rows[:, None], best_pos].max(do_expand)

        nodes = jnp.where(do_expand, jnp.take_along_axis(cand_s, best_pos, axis=1), 0)
        neigh = jnp.where(
            do_expand[:, :, None], adj[nodes], -1
        ).reshape(Q, -1)                                       # [Q, E*W]
        # duplicate neighbors can appear across the E expanded nodes; keep
        # the first occurrence only (visited bits make later ones stale, but
        # in-iteration duplicates need an explicit mask)
        nc = jnp.maximum(neigh, 0)
        words = visited[rows[:, None], nc >> 5]
        bits = jnp.uint32(1) << (nc & 31).astype(jnp.uint32)
        seen = (words & bits) != 0
        if expand > 1:
            # mask duplicates within the row: mark positions whose slot
            # appeared earlier in the same row
            sort_idx = jnp.argsort(neigh, axis=1, stable=True)
            sorted_n = jnp.take_along_axis(neigh, sort_idx, axis=1)
            rep_sorted = jnp.concatenate(
                [jnp.zeros((Q, 1), bool), sorted_n[:, 1:] == sorted_n[:, :-1]],
                axis=1,
            )
            dup = jnp.zeros_like(rep_sorted)
            dup = dup.at[rows[:, None], sort_idx].set(rep_sorted)
            seen = seen | dup
        fresh = (neigh >= 0) & ~seen
        visited = visited.at[rows[:, None], nc >> 5].add(
            jnp.where(fresh, bits, jnp.uint32(0))
        )

        nd = _neighbor_dists(queries, qn, vectors, sqnorms, neigh, kind)
        nd = jnp.where(fresh, nd, INF)
        ns = jnp.where(fresh, neigh, IDX_SENTINEL)

        # merge into the beam, carrying expanded flags through the sort
        md = jnp.concatenate([cand_d, nd], axis=1)
        ms = jnp.concatenate([cand_s, ns], axis=1)
        me = jnp.concatenate(
            [expanded, jnp.zeros_like(fresh)], axis=1
        ).astype(jnp.int32)
        sd, ss, se = lax.sort(
            (md, ms, me), dimension=1, num_keys=2 if fused_results else 1
        )
        cand_d, cand_s, expanded = sd[:, :ef], ss[:, :ef], se[:, :ef].astype(bool)

        if fused_results:
            # merge ALLOWED fresh neighbors into the result set
            rd = jnp.where(
                fresh & allowed[jnp.maximum(neigh, 0)] & (nd <= threshold), nd, INF
            )
            rs = jnp.where(rd < INF, neigh, IDX_SENTINEL)
            res_d, res_s = merge_topk(res_d, res_s, rd, rs, k)

        return (i + 1, cand_d, cand_s, expanded, visited, res_d, res_s, jnp.any(active))

    state = (jnp.int32(0), cand_d, cand_s, expanded, visited, res_d, res_s, jnp.bool_(True))
    state = lax.while_loop(cond, body, state)
    if fused_results:
        return state[5], state[6]
    # results = best k of the final beam (admission mask still applied once)
    cand_d, cand_s = state[1], state[2]
    ok = (cand_s != IDX_SENTINEL) & allowed[jnp.maximum(cand_s, 0)] & (
        cand_d <= threshold
    )
    rd = jnp.where(ok, cand_d, INF)
    rs = jnp.where(ok, cand_s, IDX_SENTINEL)
    sd, ss = lax.sort((rd, rs), dimension=1, num_keys=2)
    return sd[:, :k], ss[:, :k]


@jax.jit
def nearest_entry(queries, mem_vecs_t, mem_sqn, mem_slots):
    """Layer-0 entry selection: the nearest upper-layer member per query,
    as one matmul over all level>=1 nodes (~n/M of the corpus).

    Takes the place of lockstep greedy descent through the upper layers,
    whose per-hop gathers run as many sequential steps as the WORST query
    needs. The matmul runs in bf16 on purpose: the entry only starts the
    beam, so a near-tie flipped by rounding costs nothing but a slightly
    different start. queries [Q, d] f32; mem_vecs_t [d, M] bf16; mem_sqn
    [M] f32; mem_slots [M] i32. Returns [Q] i32 layer-0 slots."""
    ip = jnp.dot(
        queries.astype(jnp.float32).astype(jnp.bfloat16), mem_vecs_t,
        preferred_element_type=jnp.float32,
    )                                                   # [Q, M]
    d = mem_sqn[None, :] - 2.0 * ip                     # + qn is rank-free
    return mem_slots[jnp.argmin(d, axis=1)]


@partial(jax.jit, donate_argnums=(0, 1, 2))
def scatter_graph_update(
    vectors: jax.Array,   # [cap, d] (donated)
    sqnorms: jax.Array,   # [cap]    (donated)
    adj: jax.Array,       # [cap, W] (donated)
    vec_rows: jax.Array,
    vec_values: jax.Array,
    adj_rows: jax.Array,
    adj_values: jax.Array,
):
    """One-dispatch device sync of an insert round: new vectors + norms +
    touched adjacency rows."""
    vectors = vectors.at[vec_rows].set(vec_values)
    sqnorms = sqnorms.at[vec_rows].set(
        jnp.sum(vec_values * vec_values, axis=1)
    )
    adj = adj.at[adj_rows].set(adj_values)
    return vectors, sqnorms, adj
