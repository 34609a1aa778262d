"""Crash matrix beyond test_crash_recovery.py's ingest kills: SIGKILL
during batch group-commit, during background flush/compaction pressure,
after tombstoned removes of flushed docs, and with all three modalities
(vector+text+metadata) in flight. Every scenario reopens the directory in
the parent and checks the durability contract."""

import os
import signal
import subprocess
import sys
import time

import numpy as np

from comet_tpu.indexes.bm25 import BM25SearchIndex
from comet_tpu.indexes.flat import FlatIndex
from comet_tpu.indexes.metadata import RoaringMetadataIndex, eq
from comet_tpu.storage import StorageConfig, open_persistent_hybrid_index
from comet_tpu.types import DistanceKind

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"  # the child stays off the accelerator
sys.path.insert(0, {repo!r})
import numpy as np
from comet_tpu.indexes.bm25 import BM25SearchIndex
from comet_tpu.indexes.flat import FlatIndex
from comet_tpu.indexes.metadata import RoaringMetadataIndex
from comet_tpu.storage import StorageConfig, open_persistent_hybrid_index
from comet_tpu.types import DistanceKind

base, progress = sys.argv[1], sys.argv[2]
cfg = StorageConfig(
    base_dir=base,
    memtable_size_limit={mem_limit},
    flush_threshold={flush_threshold},
    compaction_interval={compaction_interval},
    vector_index_factory=lambda: FlatIndex(4, DistanceKind.L2),
    text_index_factory=BM25SearchIndex,
    metadata_index_factory=RoaringMetadataIndex,
    wal_enabled=True,
    wal_fsync=True,
)
store = open_persistent_hybrid_index(cfg)
pf = open(progress, "a")

def ack(line):
    pf.write(str(line) + "\\n")
    pf.flush()
    os.fsync(pf.fileno())
"""


def _spawn(tmp_path, body, mem_limit=1 << 20, flush_threshold=1 << 30,
           compaction_interval=3600.0):
    base = str(tmp_path / "store")
    progress = str(tmp_path / "progress.txt")
    script = str(tmp_path / "writer.py")
    with open(script, "w") as f:
        f.write(
            _PRELUDE.format(
                repo=REPO_ROOT,
                mem_limit=mem_limit,
                flush_threshold=flush_threshold,
                compaction_interval=compaction_interval,
            )
            + body
        )
    proc = subprocess.Popen(
        [sys.executable, script, base, progress],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
    )
    return proc, base, progress


def _wait_acks(proc, progress, n, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(
                "writer died early: " + proc.stderr.read().decode()[-2000:]
            )
        try:
            with open(progress) as f:
                lines = f.read().splitlines()
        except FileNotFoundError:
            lines = []
        if len(lines) >= n:
            return lines
        time.sleep(0.05)
    raise AssertionError(f"writer too slow ({len(lines)}/{n} acks)")


def _kill(proc):
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=30)


def _reopen(base):
    return open_persistent_hybrid_index(
        StorageConfig(
            base_dir=base,
            memtable_size_limit=1 << 20,
            flush_threshold=1 << 30,
            compaction_interval=3600.0,
            vector_index_factory=lambda: FlatIndex(4, DistanceKind.L2),
            text_index_factory=BM25SearchIndex,
            metadata_index_factory=RoaringMetadataIndex,
            wal_enabled=True,
        )
    )


def test_sigkill_during_batch_ingest(tmp_path):
    """Acked add_batch chunks (group-commit fsync) survive SIGKILL whole."""
    body = """
i = 0
while True:
    docs = [
        (np.array([float(i * 8 + j), 0, 0, 0], dtype=np.float32), "", None)
        for j in range(8)
    ]
    ids = store.add_batch(docs)
    ack(",".join(map(str, ids)))
    i += 1
"""
    proc, base, progress = _spawn(tmp_path, body)
    try:
        lines = _wait_acks(proc, progress, 20)
    finally:
        _kill(proc)
    with open(progress) as f:
        lines = f.read().splitlines()
    acked = [int(x) for line in lines for x in line.split(",")]
    with _reopen(base) as store:
        missing = [d for d in acked if not store.has_document(d)]
        assert not missing, f"group-committed batch docs lost: {missing[:10]}"


def test_sigkill_under_flush_and_compaction_pressure(tmp_path):
    """Tiny memtables + aggressive flush/compaction running while killed:
    reopen must still see every acked doc exactly once."""
    body = """
i = 0
while True:
    vec = np.array([float(i), 0, 0, 0], dtype=np.float32)
    doc = store.add(vec, "", None)
    ack(doc)
    if i % 25 == 0:
        store.flush()
    i += 1
"""
    proc, base, progress = _spawn(
        tmp_path, body, mem_limit=4096, flush_threshold=1,
        compaction_interval=0.2,
    )
    try:
        _wait_acks(proc, progress, 120)
        time.sleep(0.5)  # let at least one background compaction cycle run
    finally:
        _kill(proc)
    with open(progress) as f:
        acked = [int(x) for x in f.read().splitlines()]
    with _reopen(base) as store:
        missing = [d for d in acked if not store.has_document(d)]
        assert not missing, f"docs lost under flush/compaction: {missing[:10]}"
        res = (
            store.new_search()
            .with_vector([float(len(acked) // 2), 0, 0, 0])
            .with_k(1)
            .execute()
        )
        assert res and res[0].id == acked[len(acked) // 2]


def test_sigkill_after_tombstoned_remove(tmp_path):
    """remove() of a FLUSHED doc writes a durable tombstone: after SIGKILL
    and reopen the doc must stay gone from lookups and searches."""
    body = """
docs = [
    (np.array([float(i), 0, 0, 0], dtype=np.float32), "", None)
    for i in range(40)
]
ids = store.add_batch(docs)
store.flush()           # move them into an immutable segment
assert store.remove(ids[7])
assert store.remove(ids[23])
ack(",".join(map(str, ids)))
import time
while True:
    time.sleep(0.05)
"""
    proc, base, progress = _spawn(tmp_path, body)
    try:
        lines = _wait_acks(proc, progress, 1)
    finally:
        _kill(proc)
    ids = [int(x) for x in lines[0].split(",")]
    gone = {ids[7], ids[23]}
    with _reopen(base) as store:
        for d in ids:
            assert store.has_document(d) == (d not in gone), d
        res = (
            store.new_search().with_vector([7.0, 0, 0, 0]).with_k(3).execute()
        )
        assert ids[7] not in [r.id for r in res]


def test_sigkill_all_modalities_recover(tmp_path):
    """Vector + text + metadata writes all survive; every modality is
    searchable after reopen."""
    body = """
i = 0
cats = ["red", "blue"]
while True:
    vec = np.array([float(i), 0, 0, 0], dtype=np.float32)
    doc = store.add(vec, f"token{i} shared", {"cat": cats[i % 2]})
    ack(doc)
    i += 1
"""
    proc, base, progress = _spawn(tmp_path, body)
    try:
        _wait_acks(proc, progress, 60)
    finally:
        _kill(proc)
    with open(progress) as f:
        acked = [int(x) for x in f.read().splitlines()]
    with _reopen(base) as store:
        assert all(store.has_document(d) for d in acked)
        by_vec = (
            store.new_search().with_vector([5.0, 0, 0, 0]).with_k(1).execute()
        )
        assert by_vec[0].id == acked[5]
        by_text = store.new_search().with_text("token9").with_k(5).execute()
        assert acked[9] in [r.id for r in by_text]
        by_meta = (
            store.new_search().with_metadata(eq("cat", "red")).with_k(10_000).execute()
        )
        red_ids = {r.id for r in by_meta}
        assert {acked[i] for i in range(0, len(acked), 2)} <= red_ids
        assert not ({acked[i] for i in range(1, len(acked), 2)} & red_ids)
