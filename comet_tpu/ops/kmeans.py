"""K-means clustering on the device.

Behavioral port of the reference's shared trainer (clustering.go:119-243):

- Deterministic init: uniform-stride sampling — centroid j = vectors[j * (n//k)]
  (clustering.go:144-162), so training is reproducible without RNG.
- Assignment: argmin over distances; ties go to the lowest centroid index
  (Go's strict `<` comparison == argmin first-occurrence).
- Convergence: stop when no assignment changed, checked BEFORE the centroid
  update (clustering.go:203-205).
- Empty clusters keep their old centroid (clustering.go:236-238).

Design: the assignment step is a tiled [N, d] x [d, k] matmul
+ argmin; the update step is a segment-sum (one pass, like the reference's
single-pass accumulation but data-parallel). Large N streams through a
lax.scan so the [N, k] distance matrix never fully materializes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from comet_tpu.ops.distance import pairwise_scores
from comet_tpu.types import DistanceKind

DEFAULT_MAX_ITER = 20  # clustering.go:14
ASSIGN_TILE = 1 << 16


@partial(jax.jit, static_argnames=("kind", "tile"))
def _kmeans_step(
    vectors: jax.Array,   # [Npad, d] f32 (padded rows are garbage)
    valid: jax.Array,     # [Npad] bool
    prev_assign: jax.Array,  # [Npad] int32
    centroids: jax.Array,    # [k, d] f32
    kind: DistanceKind,
    tile: int,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One assignment + update step. Returns (assign, sums, counts, changed)."""
    n_pad, d = vectors.shape
    k = centroids.shape[0]
    num_tiles = n_pad // tile

    def tile_assign(x_tile, valid_tile):
        dist = pairwise_scores(x_tile, centroids, kind)  # [tile, k]
        a = jnp.argmin(dist, axis=1).astype(jnp.int32)
        # padded rows go to segment k (dropped)
        return jnp.where(valid_tile, a, k)

    if num_tiles <= 1:
        assign = tile_assign(vectors, valid)
    else:
        xs = vectors.reshape(num_tiles, tile, d)
        vs = valid.reshape(num_tiles, tile)
        _, assign_t = lax.scan(
            lambda c, inp: (c, tile_assign(*inp)), None, (xs, vs)
        )
        assign = assign_t.reshape(n_pad)

    w = valid.astype(jnp.float32)
    sums = jax.ops.segment_sum(vectors * w[:, None], assign, num_segments=k + 1)[:k]
    counts = jax.ops.segment_sum(w, assign, num_segments=k + 1)[:k]
    changed = jnp.any((assign != prev_assign) & valid)
    return assign, sums, counts, changed




@partial(jax.jit, static_argnames=("n_pad",))
def _device_pad(x: jax.Array, n_pad: int) -> tuple[jax.Array, jax.Array]:
    """Zero-pad [n, d] -> [n_pad, d] ON DEVICE and build the validity mask.

    Padding on device keeps the tile padding off the host-to-device
    transfer: uploading 100k raw rows and padding to 131072 on device
    moves 31% fewer bytes at those shapes."""
    n = x.shape[0]
    padded = jnp.zeros((n_pad, x.shape[1]), x.dtype).at[:n].set(x)
    valid = jnp.arange(n_pad, dtype=jnp.int32) < n
    return padded, valid


def init_centroids(vectors: np.ndarray, k: int) -> np.ndarray:
    """Uniform-stride deterministic init (clustering.go:144-162)."""
    n = len(vectors)
    step = max(n // k, 1)
    idx = np.minimum(np.arange(k) * step, n - 1)
    return vectors[idx].astype(np.float32).copy()


@partial(jax.jit, static_argnames=("kind", "tile", "max_iter"))
def _kmeans_loop(x_dev, valid_dev, centroids, kind, tile, max_iter):
    """Full Lloyd iteration as a device-side while_loop — ONE dispatch for
    the whole training run. The reference (and round 1) checked `changed`
    on the host every iteration, costing a device round-trip per Lloyd
    step."""
    assign0 = jnp.full(x_dev.shape[0], -1, dtype=jnp.int32)

    def cond(state):
        it, _assign, _cent, go = state
        return go & (it < max_iter)

    def body(state):
        it, assign, cent, _go = state
        new_assign, sums, counts, changed = _kmeans_step(
            x_dev, valid_dev, assign, cent, kind, tile
        )
        # converged-before-update (clustering.go:203-205): when nothing
        # changed, keep the old centroids and let cond() exit
        counts_col = counts[:, None]
        updated = jnp.where(
            counts_col > 0, sums / jnp.maximum(counts_col, 1.0), cent
        )  # empty clusters keep the old centroid (clustering.go:236-238)
        cent2 = jnp.where(changed, updated, cent)
        return it + 1, new_assign, cent2, changed

    _, assign, centroids, _ = lax.while_loop(
        cond, body, (jnp.int32(0), assign0, centroids, jnp.bool_(True))
    )
    return centroids, assign


def kmeans(
    vectors: np.ndarray,
    k: int,
    kind: DistanceKind = DistanceKind.L2_SQUARED,
    max_iter: int = DEFAULT_MAX_ITER,
    return_assign: bool = True,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Lloyd's k-means with reference-parity init/convergence/empty-cluster
    rules. Returns (centroids [k, d] f32, assignments [n] int64).

    return_assign=False skips the assignment download — callers that only
    keep the centroids (IVF/PQ train) shouldn't pay for the [n] int32
    readback."""
    vectors = np.ascontiguousarray(np.asarray(vectors, dtype=np.float32))
    n = len(vectors)
    if n == 0 or k <= 0:
        return np.zeros((0, vectors.shape[1] if vectors.ndim == 2 else 0), np.float32), np.zeros(0, np.int64)
    k = min(k, n)
    if max_iter <= 0:
        max_iter = DEFAULT_MAX_ITER

    tile = min(ASSIGN_TILE, 1 << (max(n - 1, 1)).bit_length())
    n_pad = ((n + tile - 1) // tile) * tile
    x_dev, valid = _device_pad(jnp.asarray(vectors), n_pad)

    centroids, assign = _kmeans_loop(
        x_dev, valid,
        jnp.asarray(init_centroids(vectors, k)),
        kind, tile, int(max_iter),
    )
    cent_np = np.asarray(centroids)
    if not return_assign:
        return cent_np, None
    assign_np = np.asarray(assign)[:n].astype(np.int64)
    return cent_np, assign_np


@partial(jax.jit, static_argnames=("tile",))
def _subspace_step(
    vectors: jax.Array,     # [Npad, M, dsub]
    valid: jax.Array,       # [Npad]
    prev_assign: jax.Array, # [Npad, M] int32
    codebooks: jax.Array,   # [M, k, dsub]
    tile: int,
):
    """One Lloyd step for ALL M subspaces at once (L2^2)."""
    n_pad, m, dsub = vectors.shape
    k = codebooks.shape[1]
    cn = jnp.sum(codebooks * codebooks, axis=2)  # [M, k]
    num_tiles = n_pad // tile

    def tile_assign(x_t, valid_t):
        ip = jnp.einsum(
            "nmd,mkd->nmk", x_t, codebooks,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        vn = jnp.sum(x_t * x_t, axis=2, keepdims=True)
        dist = vn + cn[None, :, :] - 2.0 * ip
        a = jnp.argmin(dist, axis=2).astype(jnp.int32)  # [tile, M]
        return jnp.where(valid_t[:, None], a, k)

    if num_tiles <= 1:
        assign = tile_assign(vectors, valid)
    else:
        xs = vectors.reshape(num_tiles, tile, m, dsub)
        vs = valid.reshape(num_tiles, tile)
        _, assign_t = lax.scan(lambda c, inp: (c, tile_assign(*inp)), None, (xs, vs))
        assign = assign_t.reshape(n_pad, m)

    # per-subspace segment sums: fold subspace index into the segment id
    offs = jnp.arange(m, dtype=jnp.int32)[None, :] * (k + 1)
    seg = (assign + offs).reshape(-1)  # [Npad * M]
    w = valid.astype(jnp.float32)
    flat_x = (vectors * w[:, None, None]).reshape(-1, dsub)
    sums = jax.ops.segment_sum(flat_x, seg, num_segments=m * (k + 1))
    counts = jax.ops.segment_sum(
        jnp.repeat(w, m), seg, num_segments=m * (k + 1)
    )
    sums = sums.reshape(m, k + 1, dsub)[:, :k]
    counts = counts.reshape(m, k + 1)[:, :k]
    changed = jnp.any((assign != prev_assign) & valid[:, None])
    return assign, sums, counts, changed


def kmeans_subspace(
    vectors: np.ndarray,  # [n, M, dsub]
    k: int,
    max_iter: int = DEFAULT_MAX_ITER,
    return_assign: bool = True,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Per-subspace k-means for PQ codebooks (clustering.go:112-115 forces
    L2^2), all M subspaces trained in LOCKSTEP on device — one batched
    einsum + segment-sum per iteration instead of M sequential k-means runs.
    Returns (codebooks [M, k, dsub], assignments [n, M])."""
    vectors = np.ascontiguousarray(np.asarray(vectors, dtype=np.float32))
    n, m, dsub = vectors.shape
    if n == 0 or k <= 0:
        return np.zeros((m, 0, dsub), np.float32), np.zeros((n, m), np.int64)
    k = min(k, n)
    if max_iter <= 0:
        max_iter = DEFAULT_MAX_ITER

    tile = min(ASSIGN_TILE, 1 << (max(n - 1, 1)).bit_length())
    n_pad = ((n + tile - 1) // tile) * tile
    flat = vectors.reshape(n, m * dsub)
    x_dev2, valid = _device_pad(jnp.asarray(flat), n_pad)
    x_dev = x_dev2.reshape(-1, m, dsub)

    # stride init per subspace (same rule as the scalar path)
    init = np.stack([init_centroids(vectors[:, s, :], k) for s in range(m)])

    codebooks, assign = _subspace_loop(
        x_dev, valid, jnp.asarray(init),
        tile, int(max_iter),
    )
    if not return_assign:
        return np.asarray(codebooks), None
    return (
        np.asarray(codebooks),
        np.asarray(assign)[:n].astype(np.int64),
    )


@partial(jax.jit, static_argnames=("m", "k", "n"))
def _residual_init(x_dev, centroids, assign, m: int, k: int, n: int):
    """Device-side residuals + per-subspace stride init for the fused
    IVFPQ train: resid = x - centroids[assign] (padded rows carry garbage,
    masked by `valid` downstream), init row j = resid[j * (n//k)] in every
    subspace — identical math to init_centroids on the host residuals."""
    nlist = centroids.shape[0]
    resid = x_dev - centroids[jnp.clip(assign, 0, nlist - 1)]
    resid3 = resid.reshape(x_dev.shape[0], m, -1)
    step = max(n // k, 1)
    idx = jnp.minimum(jnp.arange(k, dtype=jnp.int32) * step, n - 1)
    init = resid3[idx].transpose(1, 0, 2)  # [m, k, dsub]
    return resid3, init


def kmeans_ivfpq_train(
    prepped: np.ndarray,   # [n, d] f32 preprocessed training vectors
    nlist: int,
    kind: DistanceKind,
    m: int,
    ksub: int,
    max_iter: int = DEFAULT_MAX_ITER,
) -> tuple[np.ndarray, np.ndarray]:
    """Fused IVFPQ training: ONE upload of the training data, coarse Lloyd
    loop, residual computation, and the lockstep subspace loop all on
    device. The split path (ivfpq_index.go:164-259 trains coarse then PQ
    on host-materialized residuals) would upload the residual matrix as
    well — twice the transferred bytes.
    Returns (centroids [nlist, d], codebooks [m, ksub, dsub])."""
    prepped = np.ascontiguousarray(np.asarray(prepped, dtype=np.float32))
    n, d = prepped.shape
    k = min(nlist, n)
    ks = min(ksub, n)
    if max_iter <= 0:
        max_iter = DEFAULT_MAX_ITER
    tile = min(ASSIGN_TILE, 1 << (max(n - 1, 1)).bit_length())
    n_pad = ((n + tile - 1) // tile) * tile
    x_dev, valid = _device_pad(jnp.asarray(prepped), n_pad)
    centroids, assign = _kmeans_loop(
        x_dev, valid, jnp.asarray(init_centroids(prepped, k)),
        kind, tile, int(max_iter),
    )
    resid3, init = _residual_init(x_dev, centroids, assign, m, ks, n)
    codebooks, _ = _subspace_loop(resid3, valid, init, tile, int(max_iter))
    return np.asarray(centroids), np.asarray(codebooks)


@partial(jax.jit, static_argnames=("tile", "max_iter"))
def _subspace_loop(x_dev, valid_dev, codebooks, tile, max_iter):
    """Device-side Lloyd while_loop over all M subspaces in lockstep —
    one dispatch for the whole PQ codebook training run."""
    m = x_dev.shape[1]
    assign0 = jnp.full((x_dev.shape[0], m), -1, dtype=jnp.int32)

    def cond(state):
        it, _assign, _cb, go = state
        return go & (it < max_iter)

    def body(state):
        it, assign, cb, _go = state
        new_assign, sums, counts, changed = _subspace_step(
            x_dev, valid_dev, assign, cb, tile
        )
        counts_col = counts[:, :, None]
        updated = jnp.where(counts_col > 0, sums / jnp.maximum(counts_col, 1.0), cb)
        cb2 = jnp.where(changed, updated, cb)
        return it + 1, new_assign, cb2, changed

    _, assign, codebooks, _ = lax.while_loop(
        cond, body, (jnp.int32(0), assign0, codebooks, jnp.bool_(True))
    )
    return codebooks, assign


@partial(jax.jit, static_argnames=("kind",))
def _nearest_centroid(vectors: jax.Array, centroids: jax.Array, kind: DistanceKind):
    if vectors.dtype != jnp.float32:
        vectors = vectors.astype(jnp.float32)  # exact narrow-transfer cast
    dist = pairwise_scores(vectors, centroids, kind)
    return jnp.argmin(dist, axis=1).astype(jnp.int32), jnp.min(dist, axis=1)


def find_nearest_centroid(
    vectors: np.ndarray,
    centroids: np.ndarray,
    kind: DistanceKind = DistanceKind.L2_SQUARED,
) -> np.ndarray:
    """Index of the nearest centroid per vector (clustering.go:259-272).
    Integer-valued inputs are transferred in their narrow exact form
    (indexes/base.narrow_wire)."""
    from comet_tpu.indexes.base import narrow_wire

    v = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
    idx, _ = _nearest_centroid(
        jnp.asarray(narrow_wire(v)),
        jnp.asarray(centroids, dtype=jnp.float32), kind,
    )
    return np.asarray(idx).astype(np.int64)
