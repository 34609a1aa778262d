"""ctypes loader for the native kernels (*.c in this directory).

The shared object is built by `make native` (or on-demand here when a C
compiler is available); every caller falls back to a pure-numpy/JAX path
when loading fails, so the native layer is an accelerator, never a
dependency. Op codes mirror the C enums.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess

import numpy as np

OP_GT, OP_GE, OP_EQ, OP_LT, OP_LE, OP_RANGE = range(6)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = sorted(glob.glob(os.path.join(_HERE, "*.c")))
_SO = os.path.join(_HERE, "_comet_native.so")

_lib = None


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    so_m = os.path.getmtime(_SO)
    return any(os.path.getmtime(s) > so_m for s in _SRCS)


def _build() -> bool:
    """Compile for the architecture's baseline instruction set (no
    -march=native): a copied checkout may carry the binary to another CPU,
    where host-specific instructions would raise SIGILL."""
    cc = os.environ.get("CC", "cc")
    try:
        subprocess.run(
            [cc, "-O3", "-shared", "-fPIC", *_SRCS, "-o", _SO],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def _load():
    global _lib
    if os.environ.get("COMET_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    if _stale():
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.bsi_compare_pack.argtypes = [
        u64p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_uint64,
        u64p, ctypes.c_size_t, u64p,
    ]
    lib.bsi_compare_pack.restype = None
    lib.bitset_and_many.argtypes = [
        u64p, ctypes.c_size_t, ctypes.c_size_t, u64p,
    ]
    lib.bitset_and_many.restype = None
    lib.bitset_and_fold.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
        ctypes.c_size_t, u64p,
    ]
    lib.bitset_and_fold.restype = None
    lib.bm25_score_topk.argtypes = [
        i32p, f32p,                    # postings docs/tfs
        i64p, i64p, f32p,              # per-(q,term) starts/lens/idfs
        i64p,                          # qoff [Q+1]
        f32p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        u64p, ctypes.c_int64,          # allowed words, n_docs
        ctypes.c_int, ctypes.c_int,    # q_n, k
        f32p, ctypes.c_void_p, i32p,   # scores / heap / candidate scratch
        i32p, f32p,                    # out ids/scores
    ]
    lib.bm25_score_topk.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _p(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def bsi_compare_pack(
    vals: np.ndarray,      # [n] uint64 biased, n % 64 == 0, C-contiguous
    op: int,
    lo: int,
    hi: int,
    ebm_words: np.ndarray,  # [w] uint64
) -> np.ndarray | None:
    """Fused compare + pack + existence-AND; None when native is absent."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(len(vals) >> 6, dtype=np.uint64)
    lib.bsi_compare_pack(
        _p(vals, ctypes.c_uint64), len(vals), int(op),
        ctypes.c_uint64(lo & ((1 << 64) - 1)).value,
        ctypes.c_uint64(hi & ((1 << 64) - 1)).value,
        _p(ebm_words, ctypes.c_uint64), len(ebm_words),
        _p(out, ctypes.c_uint64),
    )
    return out


def bitset_and_many(rows: np.ndarray) -> np.ndarray | None:
    """AND-reduce [r, words] uint64 rows; None when native is absent."""
    lib = _load()
    if lib is None or rows.size == 0:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    out = np.empty(rows.shape[1], dtype=np.uint64)
    lib.bitset_and_many(
        _p(rows, ctypes.c_uint64), rows.shape[0], rows.shape[1],
        _p(out, ctypes.c_uint64),
    )
    return out


def bitset_and_fold(arrs: list, n: int) -> np.ndarray | None:
    """AND-fold a list of uint64 word arrays (each len >= n, C-contiguous)
    over their first n words, one memory pass with zero-block skipping.
    Returns the folded words [n], or None when native is absent."""
    lib = _load()
    if lib is None or not arrs:
        return None
    out = np.empty(n, dtype=np.uint64)
    ptrs = (ctypes.c_void_p * len(arrs))(
        *(a.ctypes.data for a in arrs)
    )
    lib.bitset_and_fold(ptrs, len(arrs), n, _p(out, ctypes.c_uint64))
    return out


def bm25_score_topk(
    docs: np.ndarray,     # [P] int32 concatenated posting doc ids
    tfs: np.ndarray,      # [P] float32 concatenated term frequencies
    starts: np.ndarray,   # [T] int64 posting range start per (q, term)
    lens: np.ndarray,     # [T] int64
    idfs: np.ndarray,     # [T] float32
    qoff: np.ndarray,     # [Q+1] int64 term ranges per query
    doc_len: np.ndarray,  # [n_docs] float32
    avgdl: float,
    k1: float,
    b: float,
    allowed: np.ndarray,  # [n_docs/64] uint64 allow-bitmask
    k: int,
):
    """Batch BM25 scoring + top-k; returns (ids [Q,k] i32 with -1 pads,
    scores [Q,k] f32) or None when native is absent."""
    lib = _load()
    if lib is None:
        return None
    q_n = len(qoff) - 1
    n_docs = len(doc_len)
    scores_buf = np.zeros(n_docs, dtype=np.float32)
    heap = np.zeros(max(k, 1) * 8, dtype=np.uint8)  # entry = 8 bytes
    cand = np.empty(n_docs, dtype=np.int32)  # per-query first-touch list
    out_ids = np.empty((q_n, k), dtype=np.int32)
    out_scores = np.empty((q_n, k), dtype=np.float32)
    lib.bm25_score_topk(
        _p(docs, ctypes.c_int32), _p(tfs, ctypes.c_float),
        _p(starts, ctypes.c_int64), _p(lens, ctypes.c_int64),
        _p(idfs, ctypes.c_float),
        _p(qoff, ctypes.c_int64),
        _p(doc_len, ctypes.c_float),
        ctypes.c_float(avgdl), ctypes.c_float(k1), ctypes.c_float(b),
        _p(allowed, ctypes.c_uint64), n_docs,
        q_n, k,
        _p(scores_buf, ctypes.c_float),
        heap.ctypes.data_as(ctypes.c_void_p),
        _p(cand, ctypes.c_int32),
        _p(out_ids, ctypes.c_int32), _p(out_scores, ctypes.c_float),
    )
    return out_ids, out_scores
