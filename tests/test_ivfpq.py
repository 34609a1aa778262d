"""IVFPQIndex tests (mirrors ivfpq_index_test.go + ivfpq_index_search_test.go
coverage, plus nprobe recall monotonicity and the nrefine extension)."""

import io

import numpy as np
import pytest

from comet_tpu.indexes.ivfpq import IVFPQIndex
from comet_tpu.types import (
    DistanceKind,
    InvalidConfigError,
    NotTrainedError,
    VectorIndexKind,
)

from oracle import distances_np, recall_at_k, topk_np


def trained_ivfpq(rng, n=500, dim=16, nlist=4, m=4, nbits=4, **kw):
    idx = IVFPQIndex(dim, DistanceKind.L2, nlist=nlist, m=m, nbits=nbits, **kw)
    data = rng.normal(size=(n, dim)).astype(np.float32)
    idx.train(data)
    idx.add_batch(data, ids=list(range(1, n + 1)))
    return idx, data


def test_params_validation():
    with pytest.raises(InvalidConfigError):
        IVFPQIndex(16, DistanceKind.L2, nlist=0)
    with pytest.raises(InvalidConfigError):
        IVFPQIndex(10, DistanceKind.L2, nlist=4, m=3)
    with pytest.raises(InvalidConfigError):
        IVFPQIndex(16, DistanceKind.L2, nlist=4, m=4, nbits=20)
    idx = IVFPQIndex(16, DistanceKind.L2, nlist=4, m=4, nbits=4)
    assert idx.kind() == VectorIndexKind.IVFPQ
    assert not idx.trained()


def test_train_needs_nlist_times_10(rng):
    idx = IVFPQIndex(16, DistanceKind.L2, nlist=10, m=4, nbits=4)
    with pytest.raises(InvalidConfigError):
        idx.train(rng.normal(size=(50, 16)).astype(np.float32))


def test_untrained_errors():
    idx = IVFPQIndex(16, DistanceKind.L2, nlist=4, m=4, nbits=4)
    with pytest.raises(NotTrainedError):
        idx.add_batch(np.zeros((1, 16), dtype=np.float32))
    with pytest.raises(NotTrainedError):
        idx.new_search().with_query([0.0] * 16).execute()


def test_search_finds_self(rng):
    idx, data = trained_ivfpq(rng)
    res = idx.new_search().with_query(data[0]).with_k(10).with_nprobes(4).execute()
    assert 1 in [r.node.id for r in res]


def test_recall_improves_with_nprobe(rng):
    idx, data = trained_ivfpq(rng, n=1000, dim=16, nlist=8, nbits=6)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data, "l2"), 10)
    true_ids = wi + 1
    recalls = []
    for nprobe in (1, 4, 8):
        found = []
        for qi in range(8):
            res = idx.new_search().with_query(q[qi]).with_k(10).with_nprobes(nprobe).execute()
            found.append([r.node.id for r in res])
        recalls.append(recall_at_k(found, true_ids))
    assert recalls[0] <= recalls[2] + 1e-9
    assert recalls[2] > 0.4  # full-probe ADC should be decent


def test_residual_encoding_beats_no_probe_restriction(rng):
    """Full-probe IVFPQ should be at least as good as plain PQ with the same
    budget (residual quantization is finer) — sanity, not exact."""
    from comet_tpu.indexes.pq import PQIndex

    rng2 = np.random.default_rng(7)
    data = rng2.normal(size=(800, 16)).astype(np.float32)
    q = rng2.normal(size=(8, 16)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data, "l2"), 10)
    true_ids = wi + 1

    ivfpq = IVFPQIndex(16, DistanceKind.L2, nlist=8, m=4, nbits=4)
    ivfpq.train(data)
    ivfpq.add_batch(data, ids=list(range(1, 801)))
    pq = PQIndex(16, DistanceKind.L2, m=4, nbits=4)
    pq.train(data)
    pq.add_batch(data, ids=list(range(1, 801)))

    def rec(idx, **kw):
        found = []
        for qi in range(8):
            s = idx.new_search().with_query(q[qi]).with_k(10)
            if kw.get("nprobes"):
                s = s.with_nprobes(kw["nprobes"])
            found.append([r.node.id for r in s.execute()])
        return recall_at_k(found, true_ids)

    assert rec(ivfpq, nprobes=8) >= rec(pq) - 0.15


def test_nrefine_improves_recall(rng):
    idx, data = trained_ivfpq(rng, n=800, store_originals=True)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    _, wi = topk_np(distances_np(q, data, "l2"), 10)
    true_ids = wi + 1

    base_found, ref_found = [], []
    for qi in range(8):
        res = idx.new_search().with_query(q[qi]).with_k(10).with_nprobes(4).execute()
        base_found.append([r.node.id for r in res])
        res = (
            idx.new_search().with_query(q[qi]).with_k(10).with_nprobes(4)
            .with_nrefine(50).execute()
        )
        ref_found.append([r.node.id for r in res])
    assert recall_at_k(ref_found, true_ids) >= recall_at_k(base_found, true_ids) - 1e-9


def test_nrefine_scores_are_exact(rng):
    idx, data = trained_ivfpq(rng, store_originals=True)
    res = (
        idx.new_search().with_query(data[3]).with_k(5).with_nprobes(4)
        .with_nrefine(50).execute()
    )
    top = res[0]
    true_d = np.linalg.norm(data[3] - data[top.node.id - 1])
    assert top.score == pytest.approx(true_d, abs=1e-4)


def test_soft_delete_flush_filter(rng):
    idx, data = trained_ivfpq(rng)
    idx.remove(1)
    res = idx.new_search().with_query(data[0]).with_k(20).with_nprobes(4).execute()
    assert 1 not in [r.node.id for r in res]
    idx.flush()
    assert idx.count() == len(data) - 1
    res = (
        idx.new_search().with_query(data[1]).with_k(20).with_nprobes(4)
        .with_document_ids([2, 3]).execute()
    )
    assert sorted(r.node.id for r in res) == [2, 3]


def test_serialization_roundtrip(rng):
    idx, data = trained_ivfpq(rng)
    buf = io.BytesIO()
    idx.write_to(buf)
    buf.seek(0)
    idx2 = IVFPQIndex(16, DistanceKind.L2, nlist=4, m=4, nbits=4)
    idx2.read_from(buf)
    assert idx2.count() == idx.count()
    r1 = idx.new_search().with_query(data[0]).with_k(5).with_nprobes(4).execute()
    r2 = idx2.new_search().with_query(data[0]).with_k(5).with_nprobes(4).execute()
    assert [r.node.id for r in r1] == [r.node.id for r in r2]


def test_serialization_roundtrip_with_originals(rng):
    idx, data = trained_ivfpq(rng, store_originals=True)
    buf = io.BytesIO()
    idx.write_to(buf)
    buf.seek(0)
    idx2 = IVFPQIndex(16, DistanceKind.L2, nlist=4, m=4, nbits=4)
    idx2.read_from(buf)
    assert idx2._store_originals
    r = (
        idx2.new_search().with_query(data[3]).with_k(5).with_nprobes(4)
        .with_nrefine(20).execute()
    )
    assert len(r) == 5


def test_serialization_param_mismatch(rng):
    idx, _ = trained_ivfpq(rng)
    buf = io.BytesIO()
    idx.write_to(buf)
    from comet_tpu.io.serial import SerializationError

    buf.seek(0)
    with pytest.raises(SerializationError):
        IVFPQIndex(16, DistanceKind.L2, nlist=8, m=4, nbits=4).read_from(buf)


def test_refine_device_matches_host_refine(rng):
    """The device re-rank (_refine_device, the nrefine stage) must order
    candidates exactly like a host numpy re-rank for every metric,
    including sentinel padding and (score, slot) ties."""
    import jax.numpy as jnp

    from comet_tpu.indexes.ivfpq import _refine_device
    from comet_tpu.ops.distance import preprocess
    from comet_tpu.ops.topk import IDX_SENTINEL

    sent = int(IDX_SENTINEL)
    for kind in (DistanceKind.L2, DistanceKind.L2_SQUARED, DistanceKind.COSINE):
        vecs = preprocess(rng.normal(size=(300, 16)).astype(np.float32), kind)
        q = preprocess(rng.normal(size=(6, 16)).astype(np.float32), kind)
        slots = rng.integers(0, 300, size=(6, 32)).astype(np.int32)
        slots[:, -3:] = sent  # padding tail
        slots[0, 1] = slots[0, 0]  # duplicate slot -> exact tie, slot break

        cand = vecs[np.where(slots != sent, slots, 0)]      # [Q, C, d]
        if kind == DistanceKind.COSINE:
            exact = 1.0 - np.clip(np.einsum("qd,qcd->qc", q, cand), -1.0, 1.0)
        else:
            diff = cand - q[:, None, :]
            exact = np.einsum("qcd,qcd->qc", diff, diff)
            if kind == DistanceKind.L2:
                exact = np.sqrt(exact)
        exact = np.where(slots != sent, exact, np.inf).astype(np.float32)
        order = np.lexsort((slots, exact), axis=1)[:, :10]
        host_s = np.take_along_axis(exact, order, axis=1)
        host_i = np.take_along_axis(slots, order, axis=1)

        dev_s, dev_i = _refine_device(
            jnp.asarray(q), jnp.asarray(slots), jnp.asarray(vecs), 10, kind
        )
        np.testing.assert_array_equal(np.asarray(dev_i), host_i)
        np.testing.assert_allclose(np.asarray(dev_s), host_s, atol=1e-4)


def test_opq_rotation_is_orthogonal_and_roundtrips(rng):
    """OPQ extension: the learned rotation is orthogonal, search serves
    original-coordinate queries (rotation fully internal), decode returns
    user-space vectors, and serialization round-trips the rotation."""
    # anisotropic data so the rotation has something to learn
    n, dim = 600, 16
    base = rng.normal(size=(n, dim)).astype(np.float32)
    scalemat = np.diag(np.linspace(0.05, 3.0, dim).astype(np.float32))
    mix = np.linalg.qr(rng.normal(size=(dim, dim)))[0].astype(np.float32)
    data = base @ scalemat @ mix

    idx = IVFPQIndex(dim, DistanceKind.L2, nlist=4, m=4, nbits=4,
                     store_originals=True, opq=True, opq_iters=3)
    idx.train(data)
    assert idx._rot is not None
    np.testing.assert_allclose(idx._rot @ idx._rot.T, np.eye(dim), atol=1e-4)
    ids = idx.add_batch(data, ids=list(range(1, n + 1)))
    assert len(ids) == n

    # decode returns user-space reconstructions (close to the original)
    rec = idx._decode(idx._store.id_to_slot[1])
    assert np.linalg.norm(rec - data[0]) < np.linalg.norm(data[0])

    # search works end-to-end and nrefine stays exact in user space
    res = (
        idx.new_search().with_query(data[3]).with_k(5).with_nprobes(4)
        .with_nrefine(50).execute()
    )
    assert res[0].node.id == 4
    true_d = np.linalg.norm(data[3] - data[res[0].node.id - 1])
    assert res[0].score == pytest.approx(true_d, abs=1e-4)

    import io as _io

    buf = _io.BytesIO()
    idx.write_to(buf)
    buf.seek(0)
    idx2 = IVFPQIndex(dim, DistanceKind.L2, nlist=4, m=4, nbits=4)
    idx2.read_from(buf)
    np.testing.assert_array_equal(idx2._rot, idx._rot)
    r1 = idx.new_search().with_query(data[7]).with_k(5).execute()
    r2 = idx2.new_search().with_query(data[7]).with_k(5).execute()
    assert [r.node.id for r in r1] == [r.node.id for r in r2]


def test_opq_improves_quantization_error(rng):
    """On anisotropic data the OPQ rotation must not increase (and should
    visibly reduce) total squared reconstruction error vs plain PQ split."""
    n, dim = 800, 16
    base = rng.normal(size=(n, dim)).astype(np.float32)
    scalemat = np.diag(np.linspace(0.05, 3.0, dim).astype(np.float32))
    mix = np.linalg.qr(rng.normal(size=(dim, dim)))[0].astype(np.float32)
    data = (base @ scalemat @ mix).astype(np.float32)

    def recon_err(opq):
        idx = IVFPQIndex(dim, DistanceKind.L2, nlist=4, m=4, nbits=4,
                         opq=opq, opq_iters=4)
        idx.train(data)
        idx.add_batch(data, ids=list(range(1, n + 1)))
        rec = np.stack([idx._decode(s) for s in range(n)])
        return float(((rec - data) ** 2).sum())

    assert recon_err(True) < recon_err(False) * 0.9
