"""The port's elastic sharded index (``qrag_tpu_torch.parallel.elastic``)
against the JAX package's, on the CPU: the elastic cases of
``tests/test_elastic_and_ring.py`` and ``tests/test_sharded_serving.py``.

The port addresses failures by mesh slot (``Slot``), where JAX addresses
a ``jax.Device``; here 8 slots on ``cpu`` stand where JAX's tests use its
8 virtual devices.  After an eviction the re-sharded index must give the
results it gave before the failure (indices exactly, scores within
rtol 1e-5) and JAX's elastic index's.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from qrag_tpu.config import QragConfig as JConfig
from qrag_tpu.engine import QragEngine as JEngine
from qrag_tpu.parallel.elastic import ElasticShardedIndex as JElastic
from qrag_tpu_torch.config import QragConfig
from qrag_tpu_torch.engine import QragEngine as TEngine
from qrag_tpu_torch.parallel import elastic as elastic_mod
from qrag_tpu_torch.parallel.elastic import ElasticShardedIndex, Slot


def _slots(n=8):
    return [Slot(i, torch.device("cpu")) for i in range(n)]


def _elastic(x, n=8, **kw):
    return ElasticShardedIndex(x, devices=_slots(n), topk_mode="exact", **kw)


def test_default_slots_follow_the_mesh_config():
    from qrag_tpu_torch.config import MeshConfig

    x = np.random.RandomState(0).randn(64, 8).astype(np.float32)
    idx = ElasticShardedIndex(x, mesh_config=MeshConfig(model_parallel=4), device="cpu",
                              topk_mode="exact")
    assert idx.devices == _slots(4)
    assert idx.layout()["mesh"] == {"data": 1, "model": 4}


def test_elastic_reshard_smaller_mesh():
    rng = np.random.RandomState(1)
    x = rng.randn(1000, 32).astype(np.float32)
    q = rng.randn(4, 32).astype(np.float32)
    idx = _elastic(x)
    before = idx.search(q, k=5)
    assert idx.probe()
    idx.remove_devices(idx.devices[4:])  # lose half the slots
    after = idx.search(q, k=5)
    np.testing.assert_array_equal(before.indices, after.indices)
    assert idx.rebuilds == 1 and idx.layout()["mesh"]["model"] == 4
    np.testing.assert_array_equal(
        after.indices, JElastic(x, topk_mode="exact").search(q, k=5).indices
    )


def test_elastic_transient_failure_keeps_capacity():
    """A one-shot failure with a healthy mesh is transient: retry, no
    eviction."""
    x = np.random.RandomState(2).randn(500, 16).astype(np.float32)
    idx = _elastic(x)

    def boom():
        raise RuntimeError("simulated transient failure")

    idx.inject_search_failure(boom)
    res = idx.search(x[3:4], k=3)
    assert res.indices[0, 0] == 3
    assert idx.rebuilds == 0 and len(idx.devices) == 8


def test_elastic_localizes_specific_dead_slot():
    """A persistently dead slot (fails searches AND its own probe) is
    localized and EXACTLY it leaves: one rebuild, results unchanged —
    and equal to JAX's elastic index after the same eviction."""
    rng = np.random.RandomState(3)
    x = rng.randn(900, 16).astype(np.float32)
    q = rng.randn(3, 16).astype(np.float32)
    idx = _elastic(x)
    before = idx.search(q, k=5)
    victim = idx.devices[2]  # not the tail
    survivors = [s for s in idx.devices if s != victim]
    idx.inject_device_failure(victim)
    after = idx.search(q, k=5)
    assert idx.rebuilds == 1 and idx.devices == survivors
    np.testing.assert_array_equal(before.indices, after.indices)
    np.testing.assert_allclose(before.scores, after.scores, rtol=1e-5)
    jidx = JElastic(x, topk_mode="exact")
    jidx.inject_device_failure(jidx.devices[2])
    jres = jidx.search(q, k=5)
    assert jidx.rebuilds == 1
    np.testing.assert_array_equal(after.indices, jres.indices)
    np.testing.assert_allclose(after.scores, jres.scores, rtol=1e-5, atol=1e-4)


def test_elastic_localizes_multiple_dead_slots():
    x = np.random.RandomState(4).randn(600, 16).astype(np.float32)
    idx = _elastic(x)
    bad = [idx.devices[1], idx.devices[5]]
    for s in bad:
        idx.inject_device_failure(s)
    res = idx.search(x[7:9], k=2)
    assert res.indices[0, 0] == 7
    assert idx.rebuilds == 1  # both evicted in ONE rebuild
    assert all(s not in idx.devices for s in bad) and len(idx.devices) == 6


def test_slots_on_one_device_are_told_apart():
    """Eight slots on one device: a failure of slot 3 evicts slot 3 only
    (the reason failures are addressed by slot)."""
    x = np.random.RandomState(5).randn(300, 8).astype(np.float32)
    idx = _elastic(x)
    assert len({s.device for s in idx.devices}) == 1
    idx.inject_device_failure(idx.devices[3])
    assert idx.localize_failures() == [Slot(3, torch.device("cpu"))]


def test_probe_device_reports_health():
    x = np.random.RandomState(6).randn(64, 8).astype(np.float32)
    idx = _elastic(x)
    assert all(idx.probe_device(s) for s in idx.devices)
    idx.inject_device_failure(idx.devices[0])
    assert not idx.probe_device(idx.devices[0])
    assert idx.localize_failures() == [idx.devices[0]]


def test_probe_deadline_on_hung_device(monkeypatch):
    """A HUNG transfer must not hang the prober: the deadline abandons
    the stuck daemon thread and reports unhealthy on schedule."""
    x = np.random.RandomState(7).randn(64, 8).astype(np.float32)
    idx = _elastic(x)
    idx.probe_timeout_s = 0.2
    monkeypatch.setattr(elastic_mod, "_put", lambda *a, **k: time.sleep(60))
    t0 = time.monotonic()
    assert not idx.probe_device(idx.devices[0])
    assert not idx.probe()
    assert time.monotonic() - t0 < 5.0


def test_hung_probe_threads_bounded():
    """Probing a persistently HUNG slot keeps at most one abandoned
    thread per target, not one per attempt."""
    x = np.random.RandomState(8).randn(64, 8).astype(np.float32)
    idx = _elastic(x, probe_timeout_s=0.05, probe_cache_ttl_s=0.0)
    victim = idx.devices[0]
    idx.inject_device_hang(victim, 1.5)
    n_before = threading.active_count()
    for _ in range(30):
        assert not idx.probe_device(victim)
    assert idx.leaked_probe_threads <= 1
    assert threading.active_count() <= n_before + 2
    assert idx.layout()["leaked_probe_threads"] <= 1
    assert idx.probe_device(idx.devices[1])


def test_unhealthy_probe_verdict_ttl_cached():
    x = np.random.RandomState(9).randn(64, 8).astype(np.float32)
    idx = _elastic(x, probe_timeout_s=0.1, probe_cache_ttl_s=30.0)
    victim = idx.devices[0]
    idx.inject_device_hang(victim, 0.5)
    assert not idx.probe_device(victim)  # pays the deadline once
    t0 = time.monotonic()
    for _ in range(20):
        assert not idx.probe_device(victim)
    assert time.monotonic() - t0 < 0.1  # cache hits, no re-probe
    idx.remove_devices([victim])
    assert victim not in idx._probe_verdicts


def test_elastic_no_devices_left():
    x = np.random.RandomState(10).randn(100, 8).astype(np.float32)
    idx = _elastic(x, n=1)
    with pytest.raises(RuntimeError, match="no healthy devices"):
        idx.remove_devices(idx.devices)


def test_elastic_engine_survives_injected_failure():
    """``index.elastic`` behind the engine: a transient failure keeps
    every slot; a persistent one evicts exactly that slot; the results
    stay those of JAX's elastic engine; appends survive re-sharding."""
    rng = np.random.RandomState(11)
    x = rng.randn(1500, 64).astype(np.float32)
    cfg = {"embedding": {"provider": "hash", "dim": 64},
           "index": {"sharded": True, "elastic": True},
           "mesh": {"data_parallel": 1, "model_parallel": 8}}
    eng = TEngine(config=QragConfig.from_dict(cfg), device="cpu")
    jeng = JEngine(config=JConfig.from_dict(cfg))
    eng.index.add(x)
    jeng.index.add(x)
    assert isinstance(eng.index, ElasticShardedIndex) and eng.index.layout()["elastic"]
    baseline = eng.search_rerank("celebrity interview", k=4, candidates=12)
    jbase = jeng.search_rerank("celebrity interview", k=4, candidates=12)
    assert [h["index"] for h in baseline["results"][0]] == [
        h["index"] for h in jbase["results"][0]]

    def boom():
        raise RuntimeError("injected transient failure")

    eng.index.inject_search_failure(boom)
    out = eng.search_rerank("celebrity interview", k=4, candidates=12)
    assert eng.index.rebuilds == 0 and eng.index.layout()["mesh"]["model"] == 8
    assert out["results"] == baseline["results"]
    victim = eng.index.devices[3]
    eng.index.inject_device_failure(victim)
    out = eng.search_rerank("celebrity interview", k=4, candidates=12)
    assert eng.index.rebuilds == 1 and eng.index.layout()["mesh"]["model"] == 7
    assert victim not in eng.index.devices
    assert [h["index"] for h in out["results"][0]] == [
        h["index"] for h in baseline["results"][0]]
    assert eng.stats()["index"]["layout"]["rebuilds"] == 1
    n0 = eng.index.ntotal
    eng.index.add(eng.index.sample_rows([0]) + 0.5)
    eng.index.inject_device_failure(eng.index.devices[-1])
    res = eng.search(eng.index.sample_rows([n0]), k=1)
    assert res.indices[0, 0] == n0 and eng.index.rebuilds == 2
