"""Product-quantization kernels: encoding and ADC (asymmetric distance).

The reference encodes one vector at a time (pq_index.go:439-473) and scores
by scalar LUT lookups per code byte (pq_index_search.go:278-296). Here:

- Encoding is a batched per-subspace distance einsum + argmin.
- ADC is expressed as a one-hot matmul: the [Q, M, Ksub] query LUT (squared
  L2 per subspace, pq_index_search.go:243-263) is contracted with one-hot
  encoded codes over the (M, Ksub) axes — a [Q, M*Ksub] x [M*Ksub, T]
  matmul per corpus tile, which is exactly the table-lookup sum in
  matmul form. Final distance = sqrt(sum), like the reference
  (pq_index_search.go:292-296), regardless of the index metric.
- Selection reuses the exact contiguous block-select top-k.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from comet_tpu.ops.distance import DEFAULT_PRECISION
from comet_tpu.ops.topk import (
    IDX_SENTINEL,
    INF,
    block_select_from_dist,
    merge_topk,
)

ADC_SUPER_TILE = 1 << 13  # 8k codes per step: one-hot buffer stays ~128 MB


@jax.jit
def pq_encode(vectors: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Encode vectors into PQ codes.

    Args:
      vectors: [B, M, dsub] float32 (reshaped, preprocessed).
      codebooks: [M, Ksub, dsub] float32.

    Returns:
      [B, M] int32 codes (argmin ties -> lowest centroid, parity with the
      reference's strict `<` scan, pq_index.go:439-473).
    """
    ip = jnp.einsum(
        "bmd,mkd->bmk", vectors, codebooks,
        preferred_element_type=jnp.float32, precision=DEFAULT_PRECISION,
    )
    vn = jnp.sum(vectors * vectors, axis=2, keepdims=True)      # [B, M, 1]
    cn = jnp.sum(codebooks * codebooks, axis=2)                  # [M, Ksub]
    dist = vn + cn[None, :, :] - 2.0 * ip
    return jnp.argmin(dist, axis=2).astype(jnp.int32)


@partial(jax.jit, static_argnames=("kind",))
def ivfpq_assign_encode(
    chunk: jax.Array,       # [B, d] f32 preprocessed
    centroids: jax.Array,   # [nlist, d] f32
    codebooks: jax.Array,   # [M, Ksub, dsub] f32
    kind,
    rot: jax.Array | None = None,  # [d, d] OPQ rotation (model space)
) -> tuple[jax.Array, jax.Array]:
    """Fused IVFPQ ingest: coarse assignment + residual + PQ encode in ONE
    device call, so bulk add uploads each vector exactly once (the split
    host path would also upload the full residual matrix — 512 MB at
    1M x 128). Matches find_nearest_centroid +
    host-residual + pq_encode bit-for-bit (same ops, same order).
    With `rot` (OPQ), the chunk is rotated into model coordinates first —
    one extra [B, d] x [d, d] matmul fused into the same dispatch.
    Returns (assign [B] i32, codes [B, M] i32)."""
    from comet_tpu.ops.distance import DEFAULT_PRECISION, pairwise_scores

    if chunk.dtype != jnp.float32:
        chunk = chunk.astype(jnp.float32)  # exact narrow-transfer cast
    if rot is not None:
        chunk = jnp.dot(chunk, rot, preferred_element_type=jnp.float32,
                        precision=DEFAULT_PRECISION)
    dist = pairwise_scores(chunk, centroids, kind)
    assign = jnp.argmin(dist, axis=1).astype(jnp.int32)
    resid = chunk - centroids[assign]
    m = codebooks.shape[0]
    codes = pq_encode(resid.reshape(chunk.shape[0], m, -1), codebooks)
    return assign, codes


def stream_device_map(fn, arrays, chunk_rows: int, out_np=True):
    """Run `fn(chunk_dev)` over row-chunks of a host array with all chunks
    dispatched before any result is collected, so uploads, compute, and
    downloads overlap. The final partial chunk is
    zero-padded to `chunk_rows` (ONE compiled shape) and the pad rows are
    sliced off the results. Returns the per-chunk outputs concatenated on
    axis 0 (numpy when out_np)."""
    n = arrays.shape[0]
    if n < chunk_rows:
        # pow2 bucket so small batches neither recompile per size nor pad
        # (and upload) the full chunk width
        chunk_rows = 1 << max(int(n - 1).bit_length(), 3)
    handles = []
    for lo in range(0, n, chunk_rows):
        chunk = arrays[lo: lo + chunk_rows]
        real = len(chunk)
        if real < chunk_rows:
            padded = np.zeros((chunk_rows,) + chunk.shape[1:], chunk.dtype)
            padded[:real] = chunk
            chunk = padded
        handles.append((fn(jnp.asarray(chunk)), real))
    outs = None
    for dev, real in handles:
        host = jax.device_get(dev)
        host = tuple(h[:real] for h in (host if isinstance(host, tuple) else (host,)))
        if outs is None:
            outs = tuple([h] for h in host)
        else:
            for acc, h in zip(outs, host):
                acc.append(h)
    cat = tuple(np.concatenate(acc, axis=0) for acc in outs)
    return cat if len(cat) > 1 else cat[0]


@jax.jit
def pq_decode(codes: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Reconstruct approximate vectors: [B, M] codes -> [B, M*dsub].

    Implemented as ONE row-gather from the flattened [M*Ksub, dsub]
    codebook (take_along_axis on a broadcast [B, M, Ksub, dsub] view makes
    XLA materialize the broadcast — an HBM OOM at 1M x 16 x 256)."""
    m, ksub, dsub = codebooks.shape
    flat = codebooks.reshape(m * ksub, dsub)
    idx = codes + jnp.arange(m, dtype=codes.dtype)[None, :] * ksub
    out = jnp.take(flat, idx.reshape(-1), axis=0)  # [B*M, dsub]
    return out.reshape(codes.shape[0], m * dsub)


@jax.jit
def build_lut(queries: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Per-query squared-L2 distance tables (pq_index_search.go:243-263).

    queries: [Q, M, dsub]; codebooks: [M, Ksub, dsub] -> [Q, M, Ksub].
    """
    ip = jnp.einsum(
        "qmd,mkd->qmk", queries, codebooks,
        preferred_element_type=jnp.float32, precision=DEFAULT_PRECISION,
    )
    qn = jnp.sum(queries * queries, axis=2, keepdims=True)
    cn = jnp.sum(codebooks * codebooks, axis=2)
    return jnp.maximum(qn + cn[None, :, :] - 2.0 * ip, 0.0)


@partial(jax.jit, static_argnames=("k", "block", "super_tile"))
def adc_topk(
    lut: jax.Array,        # [Q, M, Ksub] float32
    codes: jax.Array,      # [N, M] int32 (N = padded capacity)
    valid: jax.Array,      # [N] bool
    threshold: jax.Array,  # scalar f32 (on the FINAL sqrt'd distance)
    k: int,
    block: int = 128,
    super_tile: int = ADC_SUPER_TILE,
) -> tuple[jax.Array, jax.Array]:
    """Masked exact-ADC top-k. Returns (scores [Q, k], slots [Q, k])."""
    Q, M, Ksub = lut.shape
    N = codes.shape[0]
    st = min(super_tile, N)
    assert N % st == 0
    num_super = N // st

    def one_super(codes_st, valid_st, base):
        onehot = jax.nn.one_hot(codes_st, Ksub, dtype=jnp.float32)  # [st, M, Ksub]
        dist_sq = jnp.einsum(
            "smk,qmk->qs", onehot, lut,
            preferred_element_type=jnp.float32, precision=DEFAULT_PRECISION,
        )
        dist = jnp.sqrt(jnp.maximum(dist_sq, 0.0))
        mask = valid_st[None, :] & (dist <= threshold)
        dist = jnp.where(mask, dist, INF)
        return block_select_from_dist(dist, k, min(block, st), base)

    if num_super == 1:
        return one_super(codes, valid, 0)

    cs = codes.reshape(num_super, st, M)
    vs = valid.reshape(num_super, st)

    def body(carry, inp):
        bs, bi = carry
        codes_st, valid_st, idx = inp
        s, i = one_super(codes_st, valid_st, idx * st)
        return merge_topk(bs, bi, s, i, k), None

    init = (
        jnp.full((Q, k), INF, dtype=jnp.float32),
        jnp.full((Q, k), IDX_SENTINEL, dtype=jnp.int32),
    )
    (scores, slots), _ = lax.scan(
        body, init, (cs, vs, jnp.arange(num_super, dtype=jnp.int32))
    )
    return scores, slots
