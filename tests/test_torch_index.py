"""Parity of the PyTorch ``DeviceFlatIndex`` (and the analytic
fidelity ops it caches) with the JAX reference, on the CPU.

Same numpy inputs to ``qrag_tpu.index.flat_index.DeviceFlatIndex`` and
``qrag_tpu_torch.index.flat_index.DeviceFlatIndex(device="cpu")``:
search results equal (indices exactly, scores to rtol 1e-5), derived
state bit for bit, and the native/FAISS artifacts readable both ways.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.index.flat_index import DeviceFlatIndex as JIndex
from qrag_tpu.ops import statevector as jsv
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex as TIndex
from qrag_tpu_torch.ops import statevector as tsv


def _data(seed, n, d, b):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.choice(n, b)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    return x, q.astype(np.float32)


def _assert_same_search(ti, ji, q, k):
    rt, rj = ti.search(q, k=k), ji.search(q, k=k)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    # atol: l2 distances come from 2q.x - |q|^2 - |x|^2, whose f32
    # rounding at |x|^2 ~ 128 is an ulp of ~256 (3e-5) — the reference
    # tests' own tolerance (tests/test_bounded_topk.py)
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-5, atol=1e-4)
    assert rt.metadata == rj.metadata
    return rt


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_search_parity_bounded(metric):
    x, q = _data(0, 16384, 128, 8)
    meta = [f"row{i}" for i in range(x.shape[0])]
    ti = TIndex.from_numpy(x, metric=metric, metadata=meta, device="cpu")
    ji = JIndex.from_numpy(x, metric=metric, metadata=meta)
    assert ti._bounded_eligible(10)
    _assert_same_search(ti, ji, q, 10)
    assert (ti.fallback_rows, ti.bounded_escalations) == (
        ji.fallback_rows, ji.bounded_escalations
    )
    sv, si = ti.search_device(torch.from_numpy(q), 10)
    np.testing.assert_array_equal(si.numpy(), ji.search(q, k=10).indices)


def test_derived_state_bit_equal():
    x, _ = _data(1, 16384, 128, 1)
    ti = TIndex.from_numpy(x, normalize=True, device="cpu")
    ji = JIndex.from_numpy(x, normalize=True)
    ts, js = ti.device_buffers(), ji.device_buffers()
    assert ts.matrix.shape == tuple(js.matrix.shape) == (20480, 128)
    np.testing.assert_array_equal(ts.matrix.numpy(), np.asarray(js.matrix))
    np.testing.assert_array_equal(ts.sqnorms.numpy(), np.asarray(js.sqnorms))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    _, (scan_t, mx_t, lr_t) = ti._bounded_buffers()
    _, (scan_j, mx_j, lr_j) = ji._bounded_buffers()
    np.testing.assert_array_equal(
        scan_t.view(torch.int16).numpy(),
        np.asarray(scan_j).view(np.int16),
    )
    np.testing.assert_array_equal(mx_t.numpy(), np.asarray(mx_j))
    np.testing.assert_array_equal(lr_t.numpy(), np.asarray(lr_j))
    np.testing.assert_allclose(
        ti.fidelity_features(4).numpy(),
        np.asarray(ji.fidelity_features(4)),
        rtol=1e-6, atol=1e-7,
    )


def test_bf16_store_and_query_rounding():
    x, q = _data(2, 8192, 64, 5)
    kw = dict(metric="l2", store_dtype="bfloat16", bounded_query_dtype="store")
    ti = TIndex.from_numpy(x, device="cpu", **kw)
    ji = JIndex.from_numpy(x, **kw)
    _assert_same_search(ti, ji, q, 10)


def test_small_corpus_exact_path():
    x, q = _data(3, 1000, 32, 3)
    ti = TIndex.from_numpy(x, device="cpu")
    ji = JIndex.from_numpy(x)
    assert not ti._bounded_eligible(5)
    _assert_same_search(ti, ji, q, 5)
    te = TIndex.from_numpy(x, topk_mode="exact", device="cpu")
    _assert_same_search(te, ji, q, 5)


def test_incremental_append_then_search():
    """``add`` after the first upload takes the within-capacity device
    append (fresh buffers; the published snapshot is untouched)."""
    x, q = _data(4, 8192, 32, 4)
    extra = _data(5, 512, 32, 1)[0]
    ti = TIndex.from_numpy(x, device="cpu")
    ji = JIndex.from_numpy(x)
    _assert_same_search(ti, ji, q, 5)
    old = ti.device_buffers()
    old_matrix = old.matrix.clone()
    cap = old.matrix.shape[0]
    ti.add(extra)
    ji.add(extra)
    new = ti.device_buffers()
    assert new is not old and new.matrix.shape[0] == cap  # no regrow
    np.testing.assert_array_equal(old.matrix.numpy(), old_matrix.numpy())
    assert not old.valid[8192:].any() and new.valid[: 8192 + 512].all()
    _assert_same_search(ti, ji, q, 5)
    # the appended generation equals a full upload of the same rows
    full = TIndex.from_numpy(np.concatenate([x, extra]), device="cpu")
    fb, m = full.device_buffers(), 8192 + 512
    np.testing.assert_array_equal(new.sqnorms[:m].numpy(), fb.sqnorms[:m].numpy())
    np.testing.assert_array_equal(new.matrix[:m].numpy(), fb.matrix[:m].numpy())


def test_native_bundle_both_ways(tmp_path):
    x, q = _data(6, 4096, 32, 3)
    meta = [f"m{i}" for i in range(x.shape[0])]
    TIndex.from_numpy(x, metric="ip", metadata=meta, device="cpu").save_native(
        str(tmp_path / "t")
    )
    JIndex.from_numpy(x, metric="ip", metadata=meta).save_native(str(tmp_path / "j"))
    for src in ("t", "j"):
        ti = TIndex.load_native(str(tmp_path / src), device="cpu")
        ji = JIndex.load_native(str(tmp_path / src))
        assert ti.metric == ji.metric == "ip" and ti.ntotal == ji.ntotal
        _assert_same_search(ti, ji, q, 7)


def test_faiss_roundtrip_both_ways(tmp_path):
    x, q = _data(7, 600, 16, 2)
    path = str(tmp_path / "idx.faiss")
    TIndex.from_numpy(x, metadata=[str(i) for i in range(600)], device="cpu").save_faiss(path)
    ti = TIndex.load_faiss(path, device="cpu")
    ji = JIndex.load_faiss(path)
    _assert_same_search(ti, ji, q, 4)


def test_load_bundled_reference_index(bundled_index_path):
    ti = TIndex.load_faiss(bundled_index_path, device="cpu")
    ji = JIndex.load_faiss(bundled_index_path)
    q = ji._host_vectors[:3]
    _assert_same_search(ti, ji, q, 5)


def test_unported_options_raise_and_device_default(monkeypatch):
    for kw in (
        {"small_batch_accel": "clustered"},
        {"bounded_scan": "int8"},
        {"topk_mode": "approx"},
        {"topk_mode": "verified"},
        {"topk_mode": "refined"},
        {"use_pallas": True},
    ):
        with pytest.raises(NotImplementedError):
            TIndex(d=8, device="cpu", **kw)
    with pytest.raises(ValueError):
        TIndex(d=8, metric="cosine", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TIndex(d=8)
    assert TIndex(d=8, device="cpu").device == torch.device("cpu")


def test_fidelity_ops_match():
    rng = np.random.default_rng(8)
    for n_qubits, m in ((4, 128), (4, 3), (10, 16)):
        q = rng.standard_normal((m,)).astype(np.float32)
        docs = rng.standard_normal((50, m)).astype(np.float32)
        docs[3] = 0.0  # zero vectors pass through unnormalized
        np.testing.assert_allclose(
            tsv.fidelity_analytic(torch.from_numpy(q), torch.from_numpy(docs), n_qubits).numpy(),
            np.asarray(jsv.fidelity_analytic(jnp.asarray(q), jnp.asarray(docs), n_qubits)),
            rtol=1e-6, atol=1e-6,
        )
        ft = tsv.rotation_features(torch.from_numpy(docs), n_qubits)
        fj = jsv.rotation_features(jnp.asarray(docs), n_qubits)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-7)
        qf = tsv.rotation_features(torch.from_numpy(q[None]), n_qubits)
        np.testing.assert_allclose(
            tsv.fidelity_from_features(qf, ft[None]).numpy(),
            np.asarray(jsv.fidelity_from_features(
                jsv.rotation_features(jnp.asarray(q[None]), n_qubits), fj[None]
            )),
            rtol=1e-6, atol=1e-6,
        )


def test_concurrent_search_during_appends():
    """Lock-free readers during appends: every search sees one whole
    generation (hits index rows that exist in it), and the final state
    equals a fresh index over the same rows."""
    import sys
    import threading

    x, q = _data(9, 4096, 32, 4)
    extra = _data(10, 640, 32, 1)[0]
    ti = TIndex.from_numpy(x, device="cpu")
    ti.search(q, k=5)
    errors, stop = [], threading.Event()

    def reader():
        try:
            while not stop.is_set():
                r = ti.search(q, k=5)
                assert (r.indices >= 0).all() and (r.indices < ti.ntotal).all()
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for chunk in np.split(extra, 5):
            ti.add(chunk)
            ti.search(q, k=5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    fresh = TIndex.from_numpy(np.concatenate([x, extra]), device="cpu")
    np.testing.assert_array_equal(ti.search(q, k=5).indices, fresh.search(q, k=5).indices)
