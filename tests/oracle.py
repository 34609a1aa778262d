"""NumPy brute-force oracle used across test files.

The flat scan IS the recall oracle (SURVEY.md §4 implication: the reference
lacks a brute-force-oracle recall@k harness; we add one).
"""

import numpy as np


def preprocess_np(v, kind):
    v = np.asarray(v, dtype=np.float32)
    if kind == "cosine":
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / n
    return v


def distances_np(queries, corpus, kind, dtype=np.float32):
    """[Q, N] distances; inputs already preprocessed. `dtype` sets the
    arithmetic (float64 gives a reference for float32 device results)."""
    q = np.asarray(queries, dtype=dtype)
    x = np.asarray(corpus, dtype=dtype)
    ip = q @ x.T
    if kind == "cosine":
        return 1.0 - np.clip(ip, -1.0, 1.0)
    qn = (q * q).sum(axis=1, keepdims=True)
    xn = (x * x).sum(axis=1)
    l2sq = np.maximum(qn + xn[None, :] - 2 * ip, 0.0)
    if kind == "l2_squared":
        return l2sq
    return np.sqrt(l2sq)


def topk_np(dist, k, mask=None, threshold=None):
    """Ascending-score top-k with ascending-index tie-break.

    Returns (scores [Q, k], idx [Q, k]) with np.inf / -1 in empty slots.
    """
    d = np.array(dist, dtype=np.float32)
    if mask is not None:
        d = np.where(mask, d, np.inf)
    if threshold is not None and threshold > 0:
        d = np.where(d <= threshold, d, np.inf)
    Q, N = d.shape
    kk = min(k, N)
    order = np.argsort(d, axis=1, kind="stable")[:, :kk]
    scores = np.take_along_axis(d, order, axis=1)
    idx = np.where(np.isinf(scores), -1, order)
    out_s = np.full((Q, k), np.inf, dtype=np.float32)
    out_i = np.full((Q, k), -1, dtype=np.int64)
    out_s[:, :kk] = scores
    out_i[:, :kk] = idx
    return out_s, out_i


def recall_at_k(found_ids, true_ids):
    """Mean fraction of true neighbors retrieved, per query."""
    hits = 0
    total = 0
    for f, t in zip(found_ids, true_ids):
        tset = set(int(x) for x in t if int(x) >= 0)
        total += len(tset)
        hits += len(tset & set(int(x) for x in f))
    return hits / max(total, 1)
