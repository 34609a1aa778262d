"""REAL crash-recovery tests: a child process is SIGKILLed mid-ingest and
the parent reopens the directory and verifies what survived.

This goes beyond the byte-truncation simulations in test_wal.py /
test_corrupt_recovery.py: the kernel kills the writer with no chance to
flush, exactly the failure the WAL exists for. The reference loses every
unflushed memtable write in this scenario and its docs admit it
(/root/reference/docs/PERSISTENCE.md:1459-1465, storage.go — no WAL);
surviving it is this rebuild's headline durability advantage.

Durability contract proven here:
- wal_fsync=True: every acknowledged add (the child fsyncs its progress
  file only AFTER store.add returns) is recovered. No exceptions.
- wal_fsync=False: reopen always succeeds; the recovered set is a prefix-
  consistent subset of acknowledged docs (torn tail allowed, no corruption).
- Both: the stale LOCK left by the dead pid is taken over automatically.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from comet_tpu.indexes.flat import FlatIndex
from comet_tpu.storage import StorageConfig, open_persistent_hybrid_index
from comet_tpu.types import DistanceKind

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Child writer: adds docs forever, acking each durable add to a progress
# file (fsync'd) so the parent knows exactly which adds were acknowledged
# before the kill.  Runs on the CPU backend to stay light.
_WRITER = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"  # the child stays off the accelerator
sys.path.insert(0, {repo!r})
import numpy as np
from comet_tpu.indexes.flat import FlatIndex
from comet_tpu.storage import StorageConfig, open_persistent_hybrid_index
from comet_tpu.types import DistanceKind

base, progress, fsync, flush_every = sys.argv[1], sys.argv[2], sys.argv[3] == "1", int(sys.argv[4])
cfg = StorageConfig(
    base_dir=base,
    memtable_size_limit=1 << 20,
    flush_threshold=1 << 30,
    compaction_interval=3600.0,
    vector_index_factory=lambda: FlatIndex(4, DistanceKind.L2),
    wal_enabled=True,
    wal_fsync=fsync,
)
store = open_persistent_hybrid_index(cfg)
pf = open(progress, "a")
i = 0
while True:
    vec = np.array([float(i), 0.0, 0.0, 0.0], dtype=np.float32)
    doc = store.add(vec, "", None)
    pf.write(f"{{doc}}\\n")
    pf.flush()
    os.fsync(pf.fileno())
    if flush_every and i and i % flush_every == 0:
        store.flush()  # move some docs into immutable segments too
    i += 1
"""


def _run_writer_and_kill(tmp_path, fsync: bool, min_acked: int, flush_every: int = 0):
    base = str(tmp_path / "store")
    progress = str(tmp_path / "progress.txt")
    script = str(tmp_path / "writer.py")
    with open(script, "w") as f:
        f.write(_WRITER.format(repo=REPO_ROOT))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, script, base, progress, "1" if fsync else "0", str(flush_every)],
        env=env,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
    )
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(
                    "writer died before kill: " + proc.stderr.read().decode()
                )
            try:
                with open(progress) as f:
                    acked = f.read().splitlines()
            except FileNotFoundError:
                acked = []
            if len(acked) >= min_acked:
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"writer too slow: only {len(acked)} acked in 120s")
        # The kernel kills it mid-write: no atexit, no flush, no close.
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    with open(progress) as f:
        acked_ids = [int(line) for line in f.read().splitlines()]
    assert len(acked_ids) >= min_acked
    return base, acked_ids


def _reopen(base):
    cfg = StorageConfig(
        base_dir=base,
        memtable_size_limit=1 << 20,
        flush_threshold=1 << 30,
        compaction_interval=3600.0,
        vector_index_factory=lambda: FlatIndex(4, DistanceKind.L2),
        wal_enabled=True,
    )
    return open_persistent_hybrid_index(cfg)


def test_sigkill_fsync_recovers_every_acked_write(tmp_path):
    """wal_fsync=True: an acknowledged add survives SIGKILL. All of them."""
    base, acked = _run_writer_and_kill(tmp_path, fsync=True, min_acked=50)
    # the dead writer's LOCK file is still there; reopen must take it over
    assert os.path.exists(os.path.join(base, "LOCK"))
    with _reopen(base) as store:
        missing = [d for d in acked if not store.has_document(d)]
        assert not missing, f"fsync'd acked writes lost after SIGKILL: {missing}"
        # and they are searchable, not just present (the writer stores
        # vector [j, 0, 0, 0] for the j-th acked doc)
        res = (
            store.new_search()
            .with_vector([0.0, 0.0, 0.0, 0.0])
            .with_k(1)
            .execute()
        )
        assert res and res[0].id == acked[0]


def test_sigkill_nofsync_reopens_clean_subset(tmp_path):
    """wal_fsync=False: a torn tail may drop trailing writes, but recovery
    must be a prefix-consistent subset and the store must reopen healthy."""
    base, acked = _run_writer_and_kill(tmp_path, fsync=False, min_acked=200)
    with _reopen(base) as store:
        present = [store.has_document(d) for d in acked]
        # prefix-consistent: once a doc is missing, everything after is too
        # (WAL replay stops at the first torn/corrupt record)
        if False in present:
            first_gap = present.index(False)
            assert not any(present[first_gap:]), (
                "recovery produced a hole (non-prefix subset): "
                f"{[d for d, p in zip(acked, present) if not p][:10]}"
            )
        # store is fully usable after recovery
        new_doc = store.add(np.array([9e6, 0, 0, 0], dtype=np.float32), "", None)
        assert store.has_document(new_doc)
        assert new_doc > max(acked), "recovered MAXID must not recycle doc IDs"


def test_sigkill_with_segments_and_wal_tail(tmp_path):
    """Mixed durability: docs flushed to segments before the kill AND the
    WAL tail both survive; nothing is double-counted after replay."""
    base, acked = _run_writer_and_kill(
        tmp_path, fsync=True, min_acked=120, flush_every=40
    )
    with _reopen(base) as store:
        missing = [d for d in acked if not store.has_document(d)]
        assert not missing, f"lost across segment+WAL recovery: {missing}"
        # each doc appears exactly once in search results (the writer
        # stores vector [j, 0, 0, 0] for the j-th acked doc)
        res = (
            store.new_search()
            .with_vector([10.0, 0.0, 0.0, 0.0])
            .with_k(3)
            .execute()
        )
        ids = [r.id for r in res]
        assert len(ids) == len(set(ids))
        assert res[0].id == acked[10]


@pytest.mark.parametrize("fsync", [True, False])
def test_sigkill_double_crash(tmp_path, fsync):
    """Crash, recover, crash during recovery-write replay, recover again —
    WAL replay re-logs into fresh WALs, so a second crash is also safe."""
    base, acked = _run_writer_and_kill(tmp_path, fsync=fsync, min_acked=30)
    # first recovery
    with _reopen(base) as store:
        recovered_once = [d for d in acked if store.has_document(d)]
        # crash again without close(): simulate by abandoning the object
        # (worker threads are daemons; on real SIGKILL the WAL written
        # during replay is what a second recovery reads)
        store._closed = True  # suppress the context-manager flush
        store._stop.set()
    # the LOCK from the abandoned store is ours (same pid, alive) — remove
    # it as the dead process's kernel would have never done; same-pid reopen
    # would otherwise see a "live" holder
    os.remove(os.path.join(base, "LOCK"))
    with _reopen(base) as store:
        still = [d for d in recovered_once if store.has_document(d)]
        assert still == recovered_once, "second recovery lost re-logged docs"
