"""Distance kernels: batched query x corpus scoring as matmuls.

The reference computes one scalar distance at a time in Go loops
(distance.go:109-290). Here every metric is a tiled [Q, d] x [d, N] matmul:

- L2^2:   ||q||^2 + ||x||^2 - 2 q.x   (one matmul + rank-1 updates)
- L2:     sqrt(L2^2)
- cosine: 1 - clip(q.x, -1, 1) on pre-normalized rows (distance.go:197-216's
  preprocessing contract: both sides are unit vectors at insert time).

Host-side `preprocess` mirrors Distance.Preprocess (distance.go:244-290):
cosine normalizes (zero vector is an error), L2/L2^2 are no-ops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from comet_tpu.types import DistanceKind, ZeroVectorError

# Distance matmuls default to true float32 products: the default precision
# may run them in bf16 or TF32 (a GPU's tensor cores), which perturbs
# distances by ~0.3% relative — enough to flip neighbor order and break
# exact recall parity with the scalar-f32 reference. ANN index types may
# opt into faster, lower-precision passes explicitly.
DEFAULT_PRECISION = jax.lax.Precision.HIGHEST


def pairwise_scores(
    queries: jax.Array,
    corpus: jax.Array,
    kind: DistanceKind,
) -> jax.Array:
    """Distances from every query to every corpus row.

    Args:
      queries: [Q, d] float32, already preprocessed for `kind`.
      corpus:  [N, d] float32, already preprocessed for `kind`.
      kind: distance metric (static).

    Returns:
      [Q, N] float32 distances (lower = more similar, all kinds).
    """
    ip = jnp.dot(queries, corpus.T, preferred_element_type=jnp.float32,
                 precision=DEFAULT_PRECISION)
    if kind == DistanceKind.COSINE:
        # Both sides are unit vectors; clamp like distance.go:206-211.
        return 1.0 - jnp.clip(ip, -1.0, 1.0)
    qn = jnp.sum(queries * queries, axis=1, keepdims=True)  # [Q, 1]
    xn = jnp.sum(corpus * corpus, axis=1)  # [N]
    l2sq = jnp.maximum(qn + xn[None, :] - 2.0 * ip, 0.0)
    if kind == DistanceKind.L2_SQUARED:
        return l2sq
    return jnp.sqrt(l2sq)


def pairwise_scores_from_norms(
    queries: jax.Array,
    corpus: jax.Array,
    corpus_sqnorms: jax.Array,
    kind: DistanceKind,
    scale: jax.Array | None = None,
) -> jax.Array:
    """Like `pairwise_scores` but with precomputed corpus squared norms.

    Avoids re-reducing the corpus on every call when it is resident in HBM.
    When the corpus is stored reduced-precision (bfloat16 fast path), the
    matmul runs single-pass in that precision; full-f32 inputs keep the
    exactness-preserving full f32 precision. An int8 corpus is symmetric
    abs-max quantized storage (quantizer.go:180-247 wired into the scan):
    `scale` dequantizes the inner product, `corpus_sqnorms` must already be
    in the dequantized domain, and the HBM read is a quarter of f32 — the
    int8 values cast to bf16 exactly (8 significand bits cover ±127).
    """
    if corpus.dtype == jnp.int8:
        ip = jnp.dot(
            queries.astype(jnp.bfloat16), corpus.T.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ) * scale
    else:
        reduced = corpus.dtype != jnp.float32
        q = queries.astype(corpus.dtype) if reduced else queries
        ip = jnp.dot(
            q, corpus.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.DEFAULT if reduced else DEFAULT_PRECISION,
        )
    if kind == DistanceKind.COSINE:
        return 1.0 - jnp.clip(ip, -1.0, 1.0)
    qn = jnp.sum(queries * queries, axis=1, keepdims=True).astype(jnp.float32)
    l2sq = jnp.maximum(qn + corpus_sqnorms[None, :] - 2.0 * ip, 0.0)
    if kind == DistanceKind.L2_SQUARED:
        return l2sq
    return jnp.sqrt(l2sq)


@partial(jax.jit, static_argnames=("kind",))
def distance_one(a: jax.Array, b: jax.Array, kind: DistanceKind) -> jax.Array:
    """Scalar distance between two vectors (parity with Distance.Calculate)."""
    return pairwise_scores(a[None, :], b[None, :], kind)[0, 0]


# ---------------------------------------------------------------------------
# Host-side preprocessing (numpy; runs at insert/query time, tiny arrays)
# ---------------------------------------------------------------------------


def preprocess(vectors: np.ndarray, kind: DistanceKind) -> np.ndarray:
    """Preprocess vectors for a metric (reference: distance.go:244-290).

    cosine: returns unit-normalized copies; raises ZeroVectorError on any
    zero row. L2/L2^2: returns the input unchanged.

    Accepts [d] or [B, d]; returns float32 with the same shape.
    """
    v = np.asarray(vectors, dtype=np.float32)
    if kind != DistanceKind.COSINE:
        return v
    squeeze = v.ndim == 1
    v2 = v[None, :] if squeeze else v
    norms = np.linalg.norm(v2, axis=1)
    if np.any(norms == 0.0):
        raise ZeroVectorError("zero vector not allowed for this metric")
    out = v2 / norms[:, None]
    return out[0] if squeeze else out


def norm(v: np.ndarray) -> float:
    """L2 norm of a vector (reference: distance.go:312)."""
    return float(np.linalg.norm(np.asarray(v, dtype=np.float32)))


def scale(v: np.ndarray, factor: float) -> np.ndarray:
    """Scale a vector by a factor (reference: distance.go Scale)."""
    return np.asarray(v, dtype=np.float32) * np.float32(factor)


def normalize(v: np.ndarray) -> np.ndarray:
    """Unit-normalize a vector; raises ZeroVectorError on zero input."""
    v = np.asarray(v, dtype=np.float32)
    n = np.linalg.norm(v)
    if n == 0.0:
        raise ZeroVectorError("zero vector not allowed for this metric")
    return v / np.float32(n)
