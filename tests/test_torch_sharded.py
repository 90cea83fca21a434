"""The port's mesh and sharded index (``qrag_tpu_torch.parallel``)
against the JAX package's, on the CPU: the cases of
``tests/test_parallel.py`` (search), ``test_elastic_and_ring.py``
(ring), ``test_sharded_serving.py``, ``test_sharded_rerank.py`` and
``test_wide_mesh.py``.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
sets up; the port's mesh is 8 (or 16, 32) slots on ``cpu``, as 1 x 8
and 2 x 4 (data x model).  Indices must equal JAX's sharded index and
the single-device exact scan, tie order included, and allgather must
equal ring bit for bit; scores within rtol 1e-5 and atol 1e-4 (an l2
distance is 2q.x - |q|^2 - |x|^2, whose f32 rounding at |x|^2 ~ 64
differs by a few ulps of ~8e-6 between summation orders).  The rerank
scores (fidelity, cosine) are held to 1e-5.
"""

import json
import logging
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.config import MeshConfig as JMeshConfig
from qrag_tpu.config import QragConfig as JConfig
from qrag_tpu.engine import QragEngine as JEngine
from qrag_tpu.engine import fused_search_rerank as j_fused_search_rerank
from qrag_tpu.index.flat_index import DeviceFlatIndex as JIndex
from qrag_tpu.parallel import ShardedFlatIndex as JSharded
from qrag_tpu.parallel import make_mesh as j_make_mesh
from qrag_tpu.parallel import sharded_index as j_sharded_mod
from qrag_tpu_torch.config import MeshConfig, QragConfig
from qrag_tpu_torch.engine import QragEngine as TEngine
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex as TIndex
from qrag_tpu_torch.parallel import mesh as tmesh
from qrag_tpu_torch.parallel import sharded_index as tsh
from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex as TSharded
from qrag_tpu_torch.serving.http_app import create_server

ATOL = 1e-4  # module doc


def _tmesh(dp, mp):
    return tmesh.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), device="cpu")


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return j_make_mesh(JMeshConfig(data_parallel=2, model_parallel=4))


@pytest.fixture(scope="module")
def jmesh1x8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return j_make_mesh(JMeshConfig(data_parallel=1, model_parallel=8))


def _same(rt, rj, scores=True):
    np.testing.assert_array_equal(rt.indices, rj.indices)
    if scores:
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-5, atol=ATOL)


# ------------------------------------------------------------------ mesh


def test_mesh_shapes_and_rules(jmesh8):
    m = _tmesh(2, 4)
    assert m.shape == dict(jmesh8.shape) == {"data": 2, "model": 4}
    for dp, mp, n, want in ((-1, -1, 8, (1, 8)), (-1, 2, 8, (4, 2)), (2, -1, 8, (2, 4))):
        cfg = MeshConfig(data_parallel=dp, model_parallel=mp)
        jm = j_make_mesh(JMeshConfig(data_parallel=dp, model_parallel=mp))
        tm = tmesh.make_mesh(cfg, devices=["cpu"] * n)
        assert tuple(tm.shape.values()) == tuple(jm.shape.values()) == want
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh(MeshConfig(data_parallel=3, model_parallel=2), devices=["cpu"] * 8)
    # an explicit grid takes that many slots; a -1 grid one per device
    assert tmesh.make_mesh(MeshConfig(model_parallel=-1), device="cpu").shape["model"] == 1
    assert tmesh.mesh_devices("cpu", 5) == [torch.device("cpu")] * 5
    tmesh.distributed_init()  # single process: a no-op, as in JAX
    # an address joins a group (tests/test_torch_multihost.py); a rank
    # that finds no GPU raises before any rendezvous instead of going on
    # on the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.distributed_init("localhost:1234", 2, 0)
    t = torch.arange(16.0).reshape(8, 2)
    assert [[s.shape for s in row] for row in tmesh.row_sharded(m, t)] == [[(2, 2)] * 4] * 2
    assert torch.equal(tmesh.batch_sharded(m, t)[1][3], t[4:])
    assert all(s is t for row in tmesh.replicated(m, t) for s in row)


def test_lexsort_merge_equals_jax_on_planted_ties():
    """The ring's two-stable-sort merge against JAX's ``jnp.lexsort``
    merge, on sets full of equal values (and -inf slots)."""
    rng = np.random.RandomState(0)
    for trial in range(20):
        v = rng.choice([-np.inf, 0.0, 0.5, 1.0, 2.0], size=(4, 24)).astype(np.float32)
        i = rng.permutation(1000)[:96].reshape(4, 24).astype(np.int32)
        k = 1 + trial % 12
        jv, ji = j_sharded_mod._merge_candidates(
            jnp.asarray(v[:, :12]), jnp.asarray(i[:, :12]),
            jnp.asarray(v[:, 12:]), jnp.asarray(i[:, 12:]), k,
        )
        tv, ti = tsh._merge_candidates(
            torch.from_numpy(v[:, :12]), torch.from_numpy(i[:, :12]).long(),
            torch.from_numpy(v[:, 12:]), torch.from_numpy(i[:, 12:]).long(), k,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------- search


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sharded_search_matches_single_device(jmesh8, metric):
    rng = np.random.RandomState(1)
    x = rng.randn(3000, 64).astype(np.float32)
    q = rng.randn(8, 64).astype(np.float32)
    rt = TSharded(x, _tmesh(2, 4), metric=metric, topk_mode="exact").search(q, k=10)
    rj = JSharded(x, jmesh8, metric=metric, topk_mode="exact").search(q, k=10)
    r1 = TIndex.from_numpy(x, metric=metric, topk_mode="exact", device="cpu").search(q, k=10)
    _same(rt, rj)
    _same(rt, r1)


def test_sharded_search_tie_break(jmesh8):
    """Duplicate rows across shards: the lower global index wins."""
    rng = np.random.RandomState(2)
    x = np.tile(rng.randn(16, 32).astype(np.float32), (64, 1))
    q = rng.randn(4, 32).astype(np.float32)
    rt = TSharded(x, _tmesh(2, 4), metric="ip", topk_mode="exact").search(q, k=8)
    _same(rt, JSharded(x, jmesh8, metric="ip", topk_mode="exact").search(q, k=8))
    _same(rt, JIndex.from_numpy(x, metric="ip", topk_mode="exact").search(q, k=8))


def test_sharded_verified_duplicate_tie_contract(jmesh8):
    """Mass duplicates under "verified": the tie certificate keeps the
    lower-index contract (JAX's exact single-device order)."""
    rng = np.random.RandomState(3)
    base = rng.randn(48, 32).astype(np.float32)
    x = np.tile(base, (352, 1))  # 16896 rows: 4224 a shard, past the short-cut
    q = base[:4] + 0.01 * rng.randn(4, 32).astype(np.float32)
    rt = TSharded(x, _tmesh(2, 4), metric="ip", topk_mode="verified").search(q, k=8)
    r1 = JIndex.from_numpy(x, metric="ip", topk_mode="exact").search(q, k=8)
    np.testing.assert_array_equal(rt.indices, r1.indices)
    np.testing.assert_allclose(rt.scores, r1.scores, rtol=1e-6, atol=1e-6)


def test_sharded_search_metadata_and_odd_batch():
    x = np.random.RandomState(4).randn(500, 32).astype(np.float32)
    sh = TSharded(x, _tmesh(2, 4), metadata=[f"m/{i}" for i in range(500)], topk_mode="exact")
    res = sh.search(x[7], k=1)  # a batch of 1 on a dp=2 mesh
    assert res.indices.shape == (1, 1) and res.indices[0, 0] == 7
    assert res.metadata[0][0] == "m/7"
    with pytest.raises(ValueError, match="multiple of the data axis"):
        sh.search_device(torch.from_numpy(x[:3]), 2)


@pytest.fixture(scope="module")
def mode_corpus():
    """8 shards of 4608 rows (>= 4096, 36 windows: every mode's sharded
    arm runs), planted duplicates across shards."""
    rng = np.random.RandomState(5)
    x = rng.randn(8 * 4608, 32).astype(np.float32)
    x[:: 4608 // 3] = x[5]
    q = np.concatenate([rng.randn(6, 32).astype(np.float32), x[5:6] + 1e-3])
    exact = {m: JIndex.from_numpy(x, metric=m, topk_mode="exact") for m in ("l2", "ip")}
    return x, q, exact


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["exact", "approx", "verified", "bounded"])
def test_sharded_modes_match_jax_and_exact(jmesh1x8, mode_corpus, metric, mode):
    """Every sharded mode against JAX's sharded index in that mode (1 x 8
    mesh, the one the reference's bounded tests use) and the
    single-device exact scan; ring == allgather bit for bit; the bounded
    counters summed as JAX sums them."""
    x, q, exact = mode_corpus
    tm = _tmesh(1, 8)
    j = JSharded(x, jmesh1x8, metric=metric, topk_mode=mode)
    rj = j.search(q, k=10)
    got = {}
    for merge in ("allgather", "ring"):
        t = TSharded(x, tm, metric=metric, topk_mode=mode, merge=merge)
        got[merge] = t.search(q, k=10)
        if mode == "bounded":
            assert (t.fallback_rows, t.bounded_escalations) == (j.fallback_rows, j.bounded_escalations)
    _same(got["allgather"], rj)
    _same(got["allgather"], exact[metric].search(q, k=10))
    np.testing.assert_array_equal(got["ring"].indices, got["allgather"].indices)
    np.testing.assert_array_equal(got["ring"].scores, got["allgather"].scores)


def test_bounded_counters_from_search_and_rerank(monkeypatch, mode_corpus):
    """Every shard's (fell_back, escalated) reaches the index's counters
    from the call that made them: a search, a rerank (whose counts the
    reference's lazy pair drops) and searches on concurrent threads,
    none lost or counted twice.  The kernel's outcome is forced to
    (1, 1) a shard; the result is still the true one."""
    from qrag_tpu_torch.ops import bounded_topk

    x, q, exact = mode_corpus
    real = bounded_topk.bounded_exact_topk

    def forced(*a, **kw):
        vals, idx, _, npatch, _ = real(*a, **kw)
        return vals, idx, True, npatch, True

    monkeypatch.setattr(bounded_topk, "bounded_exact_topk", forced)
    sh = TSharded(x, _tmesh(1, 8), topk_mode="bounded")
    _same(sh.search(q, k=10), exact["l2"].search(q, k=10))
    assert (sh.fallback_rows, sh.bounded_escalations) == (8, 8)
    sh.search_rerank_device(torch.from_numpy(q[:1]), 5, 20, 4)
    assert (sh.fallback_rows, sh.bounded_escalations) == (16, 16)
    threads = [threading.Thread(target=sh.search, args=(q, 10)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (sh.fallback_rows, sh.bounded_escalations) == (48, 48)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ring_merge_matches_allgather(jmesh8, metric):
    rng = np.random.RandomState(6)
    x = rng.randn(2000, 48).astype(np.float32)
    q = rng.randn(6, 48).astype(np.float32)
    r_ring = TSharded(x, _tmesh(2, 4), metric=metric, topk_mode="exact", merge="ring").search(q, k=10)
    r_ag = TSharded(x, _tmesh(2, 4), metric=metric, topk_mode="exact").search(q, k=10)
    np.testing.assert_array_equal(r_ring.indices, r_ag.indices)
    np.testing.assert_array_equal(r_ring.scores, r_ag.scores)
    _same(r_ring, JSharded(x, jmesh8, metric=metric, topk_mode="exact", merge="ring").search(q, k=10))


def test_ring_merge_tie_break():
    rng = np.random.RandomState(7)
    x = np.tile(rng.randn(8, 16).astype(np.float32), (128, 1))
    q = rng.randn(2, 16).astype(np.float32)
    ring = TSharded(x, _tmesh(2, 4), metric="ip", topk_mode="exact", merge="ring")
    single = JIndex.from_numpy(x, metric="ip", topk_mode="exact")
    np.testing.assert_array_equal(ring.search(q, k=6).indices, single.search(q, k=6).indices)


@pytest.mark.parametrize("slots,dp", [(16, 2), (32, 4)])
def test_wide_mesh_merges_bit_identical(slots, dp):
    """Beyond 8 slots (the reference runs these in subprocesses with 16
    and 32 virtual devices): allgather and ring equal the single-device
    exact scan bit for bit, tie order included, with the data axis
    widened too."""
    rng = np.random.RandomState(0)
    base = rng.randn(1024, 64).astype(np.float32)
    x = np.concatenate([base] * 4, axis=0)  # duplicates across shards
    q = rng.randn(8, 64).astype(np.float32)
    want = JIndex.from_numpy(x, metric="l2", topk_mode="exact").search(q, k=10)
    mesh = _tmesh(dp, slots // dp)
    for merge in ("allgather", "ring"):
        got = TSharded(x, mesh, metric="l2", topk_mode="exact", merge=merge).search(q, k=10)
        np.testing.assert_array_equal(got.indices, want.indices)


def test_sharded_bounded_large_k_exact(jmesh1x8):
    """k=64 over 8 shards of 4608 rows: the large-k bounded design on
    every shard, merged exactly, equal to JAX's sharded bounded index."""
    rng = np.random.RandomState(8)
    x = rng.randn(8 * 4608, 16).astype(np.float32)
    q = rng.randn(3, 16).astype(np.float32)
    rt = TSharded(x, _tmesh(1, 8), metric="ip", topk_mode="bounded").search(q, k=40)
    _same(rt, JSharded(x, jmesh1x8, metric="ip", topk_mode="bounded").search(q, k=40))
    _same(rt, TIndex.from_numpy(x, metric="ip", topk_mode="exact", device="cpu").search(q, k=40))


def test_sharded_bounded_small_shards_degrade():
    rng = np.random.RandomState(9)
    x = rng.randn(2000, 16).astype(np.float32)  # 256 rows a shard: the sort
    q = rng.randn(3, 16).astype(np.float32)
    sh = TSharded(x, _tmesh(1, 8), topk_mode="bounded")
    exact = JIndex.from_numpy(x, topk_mode="exact", normalize=False)
    np.testing.assert_array_equal(sh.search(q, k=5).indices, exact.search(q, k=5).indices)
    assert sh.fallback_rows == 0


def test_sharded_refined_is_refused_at_the_index():
    with pytest.raises(ValueError, match="approx"):
        TSharded(d=8, mesh=_tmesh(1, 2), topk_mode="refined")


# --------------------------------------------------- append and streaming


def test_sharded_incremental_append(jmesh8):
    rng = np.random.RandomState(10)
    x = rng.randn(3000, 32).astype(np.float32)
    q = rng.randn(4, 32).astype(np.float32)
    sh = TSharded(x, _tmesh(2, 4), topk_mode="exact")
    sh.search(q, k=5)
    cap = sh._capacity
    extra = rng.randn(60, 32).astype(np.float32)
    sh.add(extra)
    res = sh.search(extra[:3], k=2)
    assert list(res.indices[:, 0]) == [3000, 3001, 3002]
    assert sh._capacity == cap  # the append stayed inside capacity
    fresh = JSharded(np.concatenate([x, extra]), jmesh8, topk_mode="exact")
    _same(sh.search(q, k=10), fresh.search(q, k=10))


def test_sharded_streaming_build_no_host_master():
    """Chunked streaming build: no host master, capacity grows slot-side,
    results equal an index over the concatenated corpus."""
    rng = np.random.RandomState(11)
    chunks = [rng.randn(256, 32).astype(np.float32) for _ in range(16)]
    sh = TSharded(mesh=_tmesh(2, 4), d=32, topk_mode="exact", keep_host_master=False)
    for i, ch in enumerate(chunks):
        sh.add(ch, metadata=[f"c{i}/{j}" for j in range(256)])
        if i % 5 == 0:
            sh.search(ch[:1], k=1)  # interleave queries with ingestion
    full = np.concatenate(chunks)
    assert sh.ntotal == 4096 and sh._host_vectors.size == 0
    q = rng.randn(4, 32).astype(np.float32)
    _same(sh.search(q, k=10), JIndex.from_numpy(full, topk_mode="exact").search(q, k=10))
    np.testing.assert_array_equal(sh.sample_rows([5, 300, 4095]), full[[5, 300, 4095]])
    assert sh.layout()["host_master"] is False


def test_sharded_streaming_checkpoint_roundtrip(tmp_path):
    rng = np.random.RandomState(12)
    chunks = [rng.randn(200, 16).astype(np.float32) for _ in range(4)]
    sh = TSharded(mesh=_tmesh(2, 4), d=16, topk_mode="exact", keep_host_master=False)
    for ch in chunks:
        sh.add(ch)
    sh.save_native(str(tmp_path / "native"))
    restored = JIndex.load_native(str(tmp_path / "native"), topk_mode="exact")
    assert restored.ntotal == 800
    q = rng.randn(3, 16).astype(np.float32)
    np.testing.assert_array_equal(sh.search(q, k=5).indices, restored.search(q, k=5).indices)
    sh.save_faiss(str(tmp_path / "stream.faiss"))
    assert JIndex.load_faiss(str(tmp_path / "stream.faiss"), topk_mode="exact").ntotal == 800


def test_sharded_streaming_rejects_reshard():
    rng = np.random.RandomState(13)
    sh = TSharded(mesh=_tmesh(2, 4), d=16, topk_mode="exact", keep_host_master=False)
    sh.add(rng.randn(100, 16).astype(np.float32))
    sh.search(rng.randn(1, 16).astype(np.float32), k=1)
    sh._needs_full, sh._dirty, sh._pending = True, True, []
    with pytest.raises(RuntimeError, match="host master"):
        sh.search(rng.randn(1, 16).astype(np.float32), k=1)


# ------------------------------------------------------ gather and rerank


def test_gather_rows_across_shards():
    x = np.random.RandomState(14).randn(1024, 16).astype(np.float32)
    sh = TSharded(x, _tmesh(2, 4), topk_mode="exact")
    idx = np.array([[0, 511, 512, 1023], [100, 600, 5, 900]])
    rows = sh.gather_rows_device(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(rows, x[idx])


def test_sharded_search_rerank_matches_single_device(jmesh8):
    rng = np.random.RandomState(15)
    x = rng.randn(2000, 32).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(4, 32).astype(np.float32)
    sh = TSharded(x, _tmesh(2, 4), metric="l2", topk_mode="exact")
    fid_t, idx_t, retr_t = sh.search_rerank_device(torch.from_numpy(q), 5, 20, 4)
    js = JSharded(x, jmesh8, metric="l2", topk_mode="exact")
    fid_s, idx_s, retr_s = js.search_rerank_device(jnp.asarray(q), 5, 20, 4)
    single = JIndex.from_numpy(x, metric="l2", topk_mode="exact")
    snap = single.device_buffers()
    fid_1, idx_1, _ = j_fused_search_rerank(
        jnp.asarray(q), snap.matrix, snap.sqnorms, snap.valid,
        k=5, candidates=20, n_qubits=4, metric="l2", topk_mode="exact",
    )
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_s))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_1))
    np.testing.assert_allclose(fid_t.numpy(), np.asarray(fid_s), atol=1e-5)
    np.testing.assert_allclose(fid_t.numpy(), np.asarray(fid_1), atol=1e-5)
    np.testing.assert_allclose(retr_t.numpy(), np.asarray(retr_s), rtol=1e-5, atol=ATOL)
    route = np.array([True, False, True, False])
    out_t = sh.search_rerank_routed_device(torch.from_numpy(q), torch.from_numpy(route), 5, 20, 4)
    out_j = js.search_rerank_routed_device(jnp.asarray(q), jnp.asarray(route), 5, 20, 4)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), atol=1e-5)


def test_sharded_accel_exact_and_counted(jmesh8):
    """The clustered accelerator per shard, merged exactly: JAX's sharded
    accelerator's answer (and the exact scan's), counters as ints, the
    structure cached; past accel_max_batch the plain sharded path."""
    rng = np.random.RandomState(16)
    centers = rng.randn(16, 64).astype(np.float32)
    x = centers[rng.randint(0, 16, 20000)] + 0.3 * rng.randn(20000, 64).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for i in (6001, 12003, 19997):  # duplicates across shards
        x[i] = x[17]
    kw = dict(metric="l2", small_batch_accel="clustered", cluster_group_rows=128,
              accel_max_batch=8, accel_read_cap=0)
    sh = TSharded(x, _tmesh(2, 4), **kw)
    js = JSharded(x, jmesh8, **kw)
    assert sh._accel_eligible(4, 10) and js._accel_eligible(4, 10)
    q = np.concatenate([x[:3] + 0.05 * rng.randn(3, 64).astype(np.float32),
                        x[17:18] + 5e-4])
    rt = sh.search(q, 10)
    exact = TIndex.from_numpy(x, topk_mode="exact", device="cpu")
    _same(rt, exact.search(q, 10))
    _same(rt, js.search(q, 10))
    assert isinstance(sh.cluster_fallbacks, int) and isinstance(sh.cluster_escalations, int)
    s1 = sh._accel_struct
    sh.search(q, 10)
    assert sh._accel_struct is s1
    qb = np.repeat(q, 4, axis=0)  # past accel_max_batch
    _same(sh.search(qb, 10), exact.search(qb, 10))


def test_sharded_accel_with_an_empty_shard():
    """Capacity headroom leaves the last shard rowless: it contributes an
    empty candidate set (no structure), and the answer stays exact."""
    rng = np.random.RandomState(20)
    x = rng.randn(4096, 32).astype(np.float32)
    sh = TSharded(x, _tmesh(1, 8), small_batch_accel="clustered", cluster_group_rows=128,
                  accel_read_cap=0)
    q = x[[3, 4000]] + 0.01 * rng.randn(2, 32).astype(np.float32)
    got = sh.search(q, 10)
    assert sh.build_clustered()[0][-1] is None
    _same(got, JIndex.from_numpy(x, topk_mode="exact").search(q, 10))


# --------------------------------------------------------------- serving

D = 64
N_ROWS = 2000


def _cfg(sharded, merge="allgather", mesh=(1, 8), **index):
    over = {"embedding": {"provider": "hash", "dim": D},
            "index": {"sharded": sharded, "shard_merge": merge, **index}}
    if sharded:
        over["mesh"] = {"data_parallel": mesh[0], "model_parallel": mesh[1]}
    return over


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(17)
    return rng.randn(N_ROWS, D).astype(np.float32), [f"doc{i}" for i in range(N_ROWS)]


@pytest.fixture(scope="module")
def engines(corpus):
    x, meta = corpus
    out = []
    for cfg, make in ((_cfg(True), lambda c: TEngine(config=QragConfig.from_dict(c), device="cpu")),
                      (_cfg(False), lambda c: TEngine(config=QragConfig.from_dict(c), device="cpu")),
                      (_cfg(True), lambda c: JEngine(config=JConfig.from_dict(c)))):
        eng = make(cfg)
        eng.index.add(x, meta)
        out.append(eng)
    return out  # port sharded, port unsharded, JAX sharded


def test_config_builds_sharded_index(engines):
    sharded, single, jsharded = engines
    assert isinstance(sharded.index, TSharded)
    lay = sharded.index.layout()
    assert lay == {**jsharded.index.layout(), "devices": 8}
    assert lay["mesh"]["model"] == 8 and lay["sharded"]
    assert sharded.stats()["index"]["effective_topk_modes"] == (
        jsharded.stats()["index"]["effective_topk_modes"])


def test_sharded_search_bit_identical(engines):
    sharded, single, jsharded = engines
    rng = np.random.RandomState(18)
    q = sharded.index.sample_rows(rng.choice(N_ROWS, 6, replace=False))
    q = q + 1e-4 * rng.randn(*q.shape).astype(np.float32)
    rs, ru, rj = sharded.search(q, k=10), single.search(q, k=10), jsharded.search(q, k=10)
    _same(rs, ru)
    _same(rs, rj)
    assert rs.metadata == ru.metadata


def _hits(out):
    return ([[h["index"] for h in r] for r in out["results"]],
            np.asarray([[h["score"] for h in r] for r in out["results"]]),
            np.asarray([[h["retrieval_score"] for h in r] for r in out["results"]]))


@pytest.mark.parametrize("rtype", ["quantum", "classical", "auto", "none"])
def test_sharded_search_rerank_matches_unsharded(engines, rtype):
    sharded, single, jsharded = engines
    queries = ["find the advertisement segment", "what did they discuss"]
    out_s = sharded.search_rerank(queries, k=5, candidates=20, reranker_type=rtype)
    for ref in (single.search_rerank(queries, k=5, candidates=20, reranker_type=rtype),
                jsharded.search_rerank(queries, k=5, candidates=20, reranker_type=rtype)):
        assert out_s["reranker_used"] == ref["reranker_used"]
        i_s, s_s, r_s = _hits(out_s)
        i_r, s_r, r_r = _hits(ref)
        assert i_s == i_r
        np.testing.assert_allclose(s_s, s_r, rtol=1e-5, atol=1e-5)
        # retrieval scores finalized on both arms (distances, not goodness)
        np.testing.assert_allclose(r_s, r_r, rtol=1e-5, atol=ATOL)


def test_sharded_ring_merge_engine(corpus):
    x, meta = corpus
    ring = TEngine(config=QragConfig.from_dict(_cfg(True, merge="ring")), device="cpu")
    ring.index.add(x, meta)
    ag = TEngine(config=QragConfig.from_dict(_cfg(True)), device="cpu")
    ag.index.add(x, meta)
    q = ag.index.sample_rows([3, 77]) + 1e-4
    r1, r2 = ring.search(q, k=7), ag.search(q, k=7)
    np.testing.assert_array_equal(r1.indices, r2.indices)
    np.testing.assert_array_equal(r1.scores, r2.scores)


def test_sharded_add_then_search():
    eng = TEngine(config=QragConfig.from_dict(_cfg(True, normalize=False)), device="cpu")
    rng = np.random.RandomState(19)
    x = rng.randn(50, D).astype(np.float32)
    eng.index.add(x, metadata=[f"m{i}" for i in range(50)])
    assert eng.search(x[17], k=3).indices[0, 0] == 17
    y = rng.randn(30, D).astype(np.float32)
    eng.index.add(y)  # re-shards lazily
    assert eng.search(y[5], k=1).indices[0, 0] == 55


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_search_and_rerank_on_sharded_corpus(engines):
    sharded, single, _ = engines
    server = create_server(sharded, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, body = _post(url, "/search", {"query": "celebrity interview", "k": 5})
        assert status == 200
        ref = single.search(np.asarray(single.embedder(["celebrity interview"])), k=5)
        assert [h["index"] for h in body["results"][0]] == [int(i) for i in ref.indices[0]]
        status, body = _post(url, "/search_rerank", {
            "query": "sponsored segment about a product deal", "k": 3,
            "candidates": 15, "reranker_type": "auto"})
        assert status == 200 and body["reranker_used"] == "auto"
        assert len(body["results"][0]) == 3
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        lay = stats["index"]["layout"]
        assert lay["sharded"] and lay["mesh"]["model"] == 8 and lay["merge"] == "allgather"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_sharded_bundle_roundtrip(engines, tmp_path):
    sharded, _, _ = engines
    bundle = str(tmp_path / "bundle")
    sharded.save(bundle)
    eng2 = TEngine.load(bundle, device="cpu")  # bundle says sharded -> sharded
    assert isinstance(eng2.index, TSharded) and eng2.index.ntotal == N_ROWS
    q = sharded.index.sample_rows([11])
    np.testing.assert_array_equal(eng2.search(q, k=4).indices, sharded.search(q, k=4).indices)
    jeng = JEngine.load(bundle)  # and the JAX package reads it, sharded
    np.testing.assert_array_equal(jeng.search(q, k=4).indices, sharded.search(q, k=4).indices)


def test_sharded_single_query_on_dp_mesh(corpus):
    """One query on a data-parallel mesh: the batch pads to the data axis."""
    x, meta = corpus
    eng = TEngine(config=QragConfig.from_dict(_cfg(True, mesh=(2, 4))), device="cpu")
    eng.index.add(x, meta)
    out = eng.search_rerank("single query on a dp mesh", k=3, candidates=10)
    assert len(out["results"]) == 1 and len(out["results"][0]) == 3
    out = eng.search_rerank(["a", "b", "c"], k=2, candidates=8, reranker_type="classical")
    assert len(out["results"]) == 3


def test_refined_downgrade_is_logged_verified_is_not(caplog):
    with caplog.at_level(logging.WARNING, logger="qrag_tpu_torch.engine"):
        eng = TEngine(config=QragConfig.from_dict(_cfg(True, topk_mode="refined")), device="cpu")
    assert any("does not support topk_mode" in r.message for r in caplog.records)
    assert eng.index.topk_mode == "approx"
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="qrag_tpu_torch.engine"):
        eng = TEngine(config=QragConfig.from_dict(_cfg(True, topk_mode="verified")), device="cpu")
    assert not any("does not support topk_mode" in r.message for r in caplog.records)
    assert eng.index.topk_mode == "verified"
    assert eng.stats()["index"]["effective_topk_modes"]["fused_candidates"] == "verified"
