"""Hostile-input recovery: corrupt/truncated segments, WALs, and blobs.

The reference tests corrupt serialized data for the hybrid index
(hybrid_search_index_test.go:868,948) but nothing at the storage layer —
a crashed writer can leave truncated gzip segments on disk. These tests
pin the failure modes: corrupted segments must not take down open() or
fan-out searches (errors are logged, healthy sources still answer), and
every index kind must reject truncated payloads with SerializationError
rather than garbage results."""

import gzip
import io
import os

import numpy as np
import pytest

from comet_tpu.indexes.bm25 import BM25SearchIndex
from comet_tpu.indexes.flat import FlatIndex
from comet_tpu.indexes.hnsw import HNSWIndex
from comet_tpu.indexes.ivf import IVFIndex
from comet_tpu.indexes.metadata import RoaringMetadataIndex
from comet_tpu.io.serial import SerializationError
from comet_tpu.storage import open_persistent_hybrid_index
from comet_tpu.types import DistanceKind

from test_storage import add_docs, make_config  # tests/ is on sys.path


def _flushed_store(tmp_path, n=10):
    store = open_persistent_hybrid_index(make_config(tmp_path))
    ids = add_docs(store, n)
    store.flush()
    assert store.segments.count() >= 1
    return store, ids


def test_truncated_segment_survives_search(tmp_path):
    store, ids = _flushed_store(tmp_path)
    seg = store.segments.list()[0]
    store.segments.evict_all_caches()
    # truncate the vector file mid-gzip-stream
    vec_path = seg.paths["vector"]
    raw = open(vec_path, "rb").read()
    with open(vec_path, "wb") as f:
        f.write(raw[: max(len(raw) // 2, 4)])
    # memtable still has nothing; segment search fails but is LOGGED,
    # not raised (divergence from storage.go:563-566 silent drop)
    res = store.new_search().with_vector([1.0, 0, 0, 0]).with_k(3).execute()
    assert isinstance(res, list)  # no crash; corrupt source contributes zero
    # fresh writes still work and win
    new_id = store.add(np.array([1.0, 0, 0, 0], np.float32), "fresh", None)
    res = store.new_search().with_vector([1.0, 0, 0, 0]).with_k(1).execute()
    assert res[0].id == new_id
    store.close()


def test_garbage_segment_on_reopen(tmp_path):
    store, ids = _flushed_store(tmp_path)
    seg_id = store.segments.list()[0].segment_id
    paths = store.segments.list()[0].paths
    store.close()
    with open(paths["hybrid"], "wb") as f:
        f.write(b"this is not gzip at all")
    with open_persistent_hybrid_index(make_config(tmp_path)) as store:
        assert store.segments.count() >= 1  # still listed
        res = store.new_search().with_vector([2.0, 0, 0, 0]).with_k(2).execute()
        assert isinstance(res, list)  # corrupt segment skipped, not fatal


def test_truncated_wal_tail_replay(tmp_path):
    cfg = make_config(tmp_path, memtable_size_limit=1 << 20)
    store = open_persistent_hybrid_index(cfg)
    ids = add_docs(store, 8)
    wal_path = store.memtables.mutable.wal.path
    store._stop.set()  # simulate crash
    os.remove(os.path.join(store.provider.base_dir, "LOCK"))
    # tear the final record
    raw = open(wal_path, "rb").read()
    with open(wal_path, "wb") as f:
        f.write(raw[:-7])
    with open_persistent_hybrid_index(make_config(tmp_path)) as again:
        live = sum(mt.index.count() for mt in again.memtables.list_all())
        assert live == 7  # last record torn and dropped, prefix recovered


def test_wal_garbage_middle_stops_at_prefix(tmp_path):
    cfg = make_config(tmp_path, memtable_size_limit=1 << 20)
    store = open_persistent_hybrid_index(cfg)
    add_docs(store, 6)
    wal_path = store.memtables.mutable.wal.path
    store._stop.set()
    os.remove(os.path.join(store.provider.base_dir, "LOCK"))
    raw = bytearray(open(wal_path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF  # flip a byte mid-log
    with open(wal_path, "wb") as f:
        f.write(bytes(raw))
    with open_persistent_hybrid_index(make_config(tmp_path)) as again:
        live = sum(mt.index.count() for mt in again.memtables.list_all())
        assert 0 < live < 6  # clean prefix only, no exception


@pytest.mark.parametrize(
    "factory",
    [
        lambda: FlatIndex(4, DistanceKind.L2),
        lambda: HNSWIndex(4, DistanceKind.L2),
        lambda: BM25SearchIndex(),
        lambda: RoaringMetadataIndex(),
    ],
    ids=["flat", "hnsw", "bm25", "metadata"],
)
def test_truncated_blob_raises(factory, rng):
    idx = factory()
    if isinstance(idx, BM25SearchIndex):
        idx.add(1, "hello world")
        idx.add(2, "another document here")
    elif isinstance(idx, RoaringMetadataIndex):
        from comet_tpu.core.node import new_metadata_node_with_id

        idx.add(new_metadata_node_with_id(1, {"k": "v", "n": 3}))
    else:
        idx.add_batch(rng.normal(size=(20, 4)).astype(np.float32),
                      ids=list(range(1, 21)))
    buf = io.BytesIO()
    idx.write_to(buf)
    blob = buf.getvalue()
    fresh = factory()
    for cut in (len(blob) // 3, len(blob) - 3):
        with pytest.raises((SerializationError, EOFError, OSError, ValueError)):
            fresh.read_from(io.BytesIO(blob[:cut]))


def test_ivf_trained_blob_truncation(rng):
    idx = IVFIndex(4, nlist=2)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    idx.train(x)
    idx.add_batch(x, ids=list(range(1, 51)))
    buf = io.BytesIO()
    idx.write_to(buf)
    blob = buf.getvalue()
    fresh = IVFIndex(4, nlist=2)
    with pytest.raises((SerializationError, EOFError, OSError, ValueError)):
        fresh.read_from(io.BytesIO(blob[: len(blob) // 2]))


def test_bloom_sidecar_corruption_is_tolerated(tmp_path):
    store, ids = _flushed_store(tmp_path)
    sid = store.segments.list()[0].segment_id
    with open(store.provider.bloom_path(sid), "wb") as f:
        f.write(b"\x00garbage")
    store.close()
    with open_persistent_hybrid_index(make_config(tmp_path)) as again:
        assert again.has_document(ids[0])  # falls back to loading segment


def test_gzip_valid_but_wrong_payload(tmp_path):
    store, ids = _flushed_store(tmp_path)
    seg = store.segments.list()[0]
    store.segments.evict_all_caches()
    with gzip.open(seg.paths["hybrid"], "wb") as f:
        f.write(b"VALID GZIP, INVALID INDEX PAYLOAD")
    res = store.new_search().with_text("document").with_k(3).execute()
    assert isinstance(res, list)
    store.close()
