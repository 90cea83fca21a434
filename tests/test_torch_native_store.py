"""The port's native host store (``qrag_tpu_torch.index.native_store``):
the reference's cases of ``tests/test_native_store.py`` against the
port's bindings and its own copy of the C++ source, built by the port
into a temporary build directory, plus the byte-identity of the copy
and the reference's numpy cluster build on the same inputs.  (The
reference's own library is never loaded here: loading it would build
it inside the reference package.)"""

import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.index import native_store as jns
from qrag_tpu.ops.topk import flat_scan_topk as j_flat_scan_topk
from qrag_tpu_torch.index import native_store as ns
from qrag_tpu_torch.ops.topk import flat_scan_topk as t_flat_scan_topk

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def built_library(tmp_path_factory):
    """The port's library, compiled into a temporary build root (and
    the module's cached handle reset around it)."""
    saved = (ns.BUILD_ROOT, ns._LIB)
    ns.BUILD_ROOT, ns._LIB = tmp_path_factory.mktemp("native_build"), None
    try:
        yield ns.load_library()
    finally:
        ns.BUILD_ROOT, ns._LIB = saved


def _rng(seed):
    return np.random.RandomState(seed)


def test_source_copy_is_byte_identical_and_built_here(built_library):
    assert ns.SOURCE.read_bytes() == (ROOT / "qrag_tpu" / "native" / "indexstore.cpp").read_bytes()
    assert ns.SOURCE.parent == ROOT / "qrag_tpu_torch" / "native"
    path = Path(built_library._name)
    assert path.parent.parent == ns.BUILD_ROOT and path.exists()
    # one directory per (source, flags, host target): a rebuild is a no-op
    assert ns.build_library(ns.BUILD_ROOT) == path


def test_create_append_read(tmp_path):
    rng = _rng(0)
    with ns.NativeVectorStore(str(tmp_path / "store.qidx"), d=32, metric="l2") as store:
        a = rng.randn(10, 32).astype(np.float32)
        b = rng.randn(2000, 32).astype(np.float32)  # forces capacity growth
        assert store.append(a) == 10
        assert store.append(b) == 2010
        assert store.ntotal == 2010 and store.d == 32
        np.testing.assert_array_equal(store.read(0, 10), a)
        np.testing.assert_array_equal(store.read(10), b)


def test_reopen_persists(tmp_path):
    path = str(tmp_path / "p.qidx")
    x = _rng(1).randn(7, 16).astype(np.float32)
    with ns.NativeVectorStore(path, d=16, metric="ip", normalized=True) as s:
        s.append(x)
        s.flush()
    with ns.NativeVectorStore(path, writable=False) as s:
        assert s.ntotal == 7 and s.metric == "ip" and s.normalized
        np.testing.assert_array_equal(s.read(), x)


def test_dim_mismatch_rejected(tmp_path):
    path = str(tmp_path / "d.qidx")
    with ns.NativeVectorStore(path, d=8) as s:
        s.append(_rng(2).randn(2, 8).astype(np.float32))
        with pytest.raises(ValueError):
            s.append(_rng(2).randn(2, 16).astype(np.float32))
    with pytest.raises(OSError):
        ns.NativeVectorStore(path, d=16)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_scan_parity_with_both_packages(metric):
    """C++ heap scan == the JAX exact scan == the port's, tie order
    included."""
    rng = _rng(3)
    x = rng.randn(500, 24).astype(np.float32)
    q = rng.randn(6, 24).astype(np.float32)
    s_c, i_c = ns.cpu_scan_topk(x, q, 10, metric=metric)
    s_j, i_j = j_flat_scan_topk(jnp.asarray(q), jnp.asarray(x), 10, metric=metric, mode="exact")
    s_t, i_t = t_flat_scan_topk(torch.from_numpy(q), torch.from_numpy(x), 10, metric=metric)
    np.testing.assert_array_equal(i_c, np.asarray(i_j))
    np.testing.assert_array_equal(i_c, i_t.numpy())
    np.testing.assert_allclose(s_c, s_t.numpy(), rtol=1e-4, atol=1e-4)


def test_scan_tie_break_lower_index():
    rng = _rng(4)
    x = np.repeat(rng.randn(5, 8).astype(np.float32), 4, axis=0)
    q = rng.randn(1, 8).astype(np.float32)
    _, idx = ns.cpu_scan_topk(x, q, 8, metric="ip")
    _, idx_t = t_flat_scan_topk(torch.from_numpy(q), torch.from_numpy(x), 8, metric="ip")
    np.testing.assert_array_equal(idx, idx_t.numpy())


def test_store_scan_topk(tmp_path):
    x = _rng(5).randn(300, 16).astype(np.float32)
    with ns.NativeVectorStore(str(tmp_path / "s.qidx"), d=16, metric="l2") as s:
        s.append(x)
        scores, idx = s.scan_topk(x[42], k=3)
        assert idx[0, 0] == 42 and scores[0, 0] < 1e-5


def test_k_exceeds_ntotal_padding(tmp_path):
    with ns.NativeVectorStore(str(tmp_path / "k.qidx"), d=8) as s:
        s.append(_rng(6).randn(3, 8).astype(np.float32))
        scores, idx = s.scan_topk(_rng(7).randn(1, 8).astype(np.float32), k=6)
        assert (idx[0, 3:] == -1).all() and np.isinf(scores[0, 3:]).all()


def test_concurrent_append_and_read(tmp_path):
    """Readers never see torn rows while one writer appends."""
    path = str(tmp_path / "c.qidx")
    d = 16
    writer_store = ns.NativeVectorStore(path, d=d, metric="ip")
    writer_store.append(np.full((1, d), 7.0, np.float32))
    stop = threading.Event()
    errors = []

    def writer():
        for i in range(300):
            writer_store.append(np.full((4, d), float(i % 50) + 1.0, np.float32))

    def reader():
        reader_store = ns.NativeVectorStore(path, writable=False)
        try:
            while not stop.is_set():
                n = reader_store.ntotal
                rows = reader_store.read(0, n)
                if not np.all(rows == rows[:, :1]):
                    errors.append("torn row observed")
                    return
        finally:
            reader_store.close()

    threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    threads[0].join(timeout=60)
    stop.set()
    for t in threads[1:]:
        t.join(timeout=60)
    writer_store.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors


def test_reader_sees_growth_after_open(tmp_path):
    path = str(tmp_path / "grow.qidx")
    d = 16
    rng = _rng(8)
    writer = ns.NativeVectorStore(path, d=d, metric="ip")
    first = rng.randn(1, d).astype(np.float32)
    writer.append(first)
    reader = ns.NativeVectorStore(path, writable=False)
    try:
        np.testing.assert_array_equal(reader.read(0, 1), first)
        big = rng.randn(5000, d).astype(np.float32)
        writer.append(big)  # past the initial capacity: ftruncate + remap
        assert reader.ntotal == 5001
        got = reader.read(0, 5001)
        np.testing.assert_array_equal(got[0], first[0])
        np.testing.assert_array_equal(got[1:], big)
        scores, idx = reader.scan_topk(big[4321], k=3)
        s_ref, i_ref = ns.cpu_scan_topk(np.concatenate([first, big]), big[4321], 3, metric="ip")
        np.testing.assert_array_equal(idx, i_ref)
        np.testing.assert_allclose(scores, s_ref, rtol=1e-5)
    finally:
        reader.close()
        writer.close()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_to_device_index(tmp_path, metric):
    """The bridge loads the rows into the port's index (on the CPU when
    asked): its search equals the store's scan."""
    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

    x = _rng(9).randn(50, 12).astype(np.float32)
    with ns.NativeVectorStore(str(tmp_path / "dev.qidx"), d=12, metric=metric) as s:
        s.append(x)
        idx = s.to_device_index(device="cpu")
        _, want = s.scan_topk(x[:5], 4)
    assert isinstance(idx, DeviceFlatIndex) and idx.metric == metric
    assert idx.device == torch.device("cpu")
    np.testing.assert_array_equal(idx.search(x[:5], k=4).indices, want)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_threaded_scan_matches_single_thread(metric):
    rng = _rng(10)
    x = rng.randn(20000, 32).astype(np.float32)
    x[1000:1004] = x[999]  # exact ties across a thread boundary region
    qb = rng.randn(16, 32).astype(np.float32)
    s1, i1 = ns.cpu_scan_topk(x, qb, 10, metric=metric, threads=1)
    s4, i4 = ns.cpu_scan_topk(x, qb, 10, metric=metric, threads=4)
    np.testing.assert_array_equal(i1, i4)
    np.testing.assert_array_equal(s1, s4)
    q1 = x[999:1000] + 0.0
    s1, i1 = ns.cpu_scan_topk(x, q1, 10, metric=metric, threads=1)
    s4, i4 = ns.cpu_scan_topk(x, q1, 10, metric=metric, threads=6)
    np.testing.assert_array_equal(i1, i4)
    np.testing.assert_allclose(s1, s4, rtol=1e-6, atol=1e-6)


def test_threaded_scan_k_exceeds_ntotal():
    x = _rng(11).randn(5, 8).astype(np.float32)
    s, i = ns.cpu_scan_topk(x, _rng(12).randn(1, 8).astype(np.float32), 9, metric="ip", threads=3)
    assert (i[0, 5:] == -1).all() and np.isneginf(s[0, 5:]).all()


def test_store_threaded_scan(tmp_path):
    x = _rng(13).randn(3000, 16).astype(np.float32)
    with ns.NativeVectorStore(str(tmp_path / "mt.qidx"), d=16, metric="l2") as s:
        s.append(x)
        s1, i1 = s.scan_topk(x[:8], k=5, threads=1)
        s4, i4 = s.scan_topk(x[:8], k=5, threads=4)
        np.testing.assert_array_equal(i1, i4)
        np.testing.assert_array_equal(s1, s4)
        assert (i1[:, 0] == np.arange(8)).all()


def _clustered(rng, n, d, n_centers=8, spread=0.03):
    centers = rng.randn(n_centers, d).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.randint(0, n_centers, n)] + spread * rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def test_host_clusters_equal_reference():
    """build_host_clusters is the reference's numpy build: the same
    structure bit for bit."""
    x = _clustered(_rng(14), 6000, 32)
    ct = ns.build_host_clusters(x, rows_per_cluster=512, iters=3)
    cj = jns.build_host_clusters(x, rows_per_cluster=512, iters=3)
    for name in ("order", "goff", "cent", "csq", "radii", "mxn", "xsq"):
        np.testing.assert_array_equal(getattr(ct, name), getattr(cj, name))


def test_native_cluster_topk_exact_and_prunes():
    rng = _rng(15)
    x = _clustered(rng, 20000, 48)
    clusters = ns.build_host_clusters(x, rows_per_cluster=512, iters=5)
    q = _clustered(rng, 16, 48)
    for metric in ("l2", "ip"):
        s, i, stats = ns.raw_cluster_topk(x, clusters, q, 10, metric=metric)
        s0, i0 = ns.cpu_scan_topk(x, q, 10, metric=metric)
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_allclose(s, s0, rtol=1e-6, atol=1e-6)
        assert stats[0] == 0, f"{metric}: fallbacks on clustered data"
    xu = rng.randn(5000, 48).astype(np.float32)
    xu /= np.linalg.norm(xu, axis=1, keepdims=True)
    cu = ns.build_host_clusters(xu, rows_per_cluster=512, iters=3)
    qu = rng.randn(4, 48).astype(np.float32)
    s, i, _ = ns.raw_cluster_topk(xu, cu, qu, 10)
    s0, i0 = ns.cpu_scan_topk(xu, qu, 10)
    np.testing.assert_array_equal(i, i0)
    np.testing.assert_allclose(s, s0, rtol=1e-6, atol=1e-6)


def test_native_cluster_topk_ties_and_budget():
    rng = _rng(16)
    x = _clustered(rng, 8000, 32)
    dup = x[97].copy()
    for j in (97, 2001, 5003, 7999):
        x[j] = dup
    clusters = ns.build_host_clusters(x, rows_per_cluster=512, iters=4)
    q = (dup + 0.0002 * rng.randn(32)).astype(np.float32)[None, :]
    s, i, _ = ns.raw_cluster_topk(x, clusters, q, 8)
    s0, i0 = ns.cpu_scan_topk(x, q, 8)
    np.testing.assert_array_equal(i, i0)
    _, i1, _ = ns.raw_cluster_topk(x, clusters, q, 8, budget=1)  # floors at k
    np.testing.assert_array_equal(i1, i0)
    x2 = _clustered(rng, 8000, 32)
    v = x2[500].copy()
    for j in rng.choice(8000, size=40, replace=False):
        x2[j] = v
    c2 = ns.build_host_clusters(x2, rows_per_cluster=512, iters=4)
    _, i2, _ = ns.raw_cluster_topk(x2, c2, v[None, :], 10)
    _, i20 = ns.cpu_scan_topk(x2, v[None, :], 10)
    np.testing.assert_array_equal(i2, i20)
    xu = rng.randn(20000, 32).astype(np.float32)
    xu /= np.linalg.norm(xu, axis=1, keepdims=True)
    cu = ns.build_host_clusters(xu, rows_per_cluster=256, iters=2)
    qu = rng.randn(3, 32).astype(np.float32)
    _, iu, stu = ns.raw_cluster_topk(xu, cu, qu, 10)
    _, iu0 = ns.cpu_scan_topk(xu, qu, 10)
    np.testing.assert_array_equal(iu, iu0)
    assert stu[0] + stu[1] > 0, "uniform data must fire the ladder"


def test_store_cluster_topk(tmp_path):
    rng = _rng(17)
    x = _clustered(rng, 6000, 32)
    store = ns.NativeVectorStore(str(tmp_path / "s.qidx"), d=32, metric="l2")
    try:
        store.append(x)
        s, i, _ = store.cluster_topk(x[:3] + 0.001, 5)
        s0, i0 = store.scan_topk(x[:3] + 0.001, 5)
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_allclose(s, s0, rtol=1e-6, atol=1e-6)
        c1 = store.build_clusters()
        assert store.build_clusters() is c1  # cached
        extra = _clustered(rng, 64, 32)
        store.append(extra)
        assert store.build_clusters() is not c1  # append invalidates
        _, i2, _ = store.cluster_topk(extra[:2], 5)
        _, i20 = store.scan_topk(extra[:2], 5)
        np.testing.assert_array_equal(i2, i20)
    finally:
        store.close()


def test_native_cluster_topk_mt_matches_single():
    rng = _rng(18)
    x = _clustered(rng, 12000, 32)
    clusters = ns.build_host_clusters(x, rows_per_cluster=512, iters=3)
    q = _clustered(rng, 16, 32)
    s1, i1, st1 = ns.raw_cluster_topk(x, clusters, q, 10, threads=1)
    s4, i4, st4 = ns.raw_cluster_topk(x, clusters, q, 10, threads=4)
    np.testing.assert_array_equal(i1, i4)
    np.testing.assert_array_equal(s1, s4)
    np.testing.assert_array_equal(st1, st4)


def test_store_cluster_topk_empty_store(tmp_path):
    with ns.NativeVectorStore(str(tmp_path / "e.qidx"), d=16) as s:
        sc, i, _ = s.cluster_topk(_rng(19).randn(2, 16).astype(np.float32), 5)
        assert (i == -1).all() and np.isinf(sc).all()


def test_host_oracle_agrees_with_device_accelerator():
    """The host tier is the accelerator's oracle: the store's clustered
    search, its exact scan and the port's clustered index on the CPU
    give the same identity."""
    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

    rng = _rng(20)
    x = _clustered(rng, 8192, 32, n_centers=16)
    q = _clustered(rng, 4, 32, n_centers=16)
    _, i_host, _ = ns.raw_cluster_topk(x, ns.build_host_clusters(x, 512, 4), q, 10)
    _, i_scan = ns.cpu_scan_topk(x, q, 10)
    idx = DeviceFlatIndex.from_numpy(
        x, small_batch_accel="clustered", cluster_group_rows=128, accel_read_cap=0, device="cpu"
    )
    res = idx.search(q, 10)
    np.testing.assert_array_equal(i_host, i_scan)
    np.testing.assert_array_equal(res.indices, i_scan)
