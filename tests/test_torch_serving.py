"""The port's serving layer against the JAX engine on one corpus and
config (N=16384 unit rows, d=128, hash embedder; candidates=100 so the
bounded large-k arm runs): the routed fused rerank, "auto" /
"classical" / "quantum" search_rerank, the document-list rerank, the
pipelined rerank, recall sampling, the batcher, and the HTTP surface
(POST /rerank, /docs, /stats?recall=1, batching).
"""

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.config import QragConfig as JConfig
from qrag_tpu.documents import Document as JDoc
from qrag_tpu.engine import QragEngine as JEngine
from qrag_tpu.engine import fused_search_rerank_routed as j_routed
from qrag_tpu_torch.config import QragConfig as TConfig
from qrag_tpu_torch.documents import Document as TDoc
from qrag_tpu_torch.engine import QragEngine as TEngine
from qrag_tpu_torch.engine import fused_search_rerank_routed as t_routed
from qrag_tpu_torch.serving import batcher as tbatcher
from qrag_tpu_torch.serving.http_app import create_server

N, D = 16384, 128
CFG = {"embedding": {"provider": "hash", "dim": D}}
TEXTS = [
    "find the advertisement segment",  # keyword: quantum
    "what is the weather today",  # classical
    "please add numbers",  # "ad" in "add": quantum
    "a b c d e f g h i j",  # > 8 words: quantum
]
DOCS = ["buy our product now", "the weather is nice", "sponsored by acme", "unrelated chatter"]


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    je = JEngine(config=JConfig.from_dict(CFG))
    te = TEngine(config=TConfig.from_dict(CFG), device="cpu")
    meta = [f"doc{i}" for i in range(N)]
    je.index.add(x, meta)
    te.index.add(x, meta)
    return je, te


def _queries(seed, b):
    return np.random.default_rng(seed).standard_normal((b, D)).astype(np.float32)


def _hits(out):
    idx = [[h["index"] for h in r] for r in out["results"]]
    return idx, np.asarray([[h["score"] for h in r] for r in out["results"]])


def _assert_same(ot, oj, atol=1e-5):
    assert ot["reranker_used"] == oj["reranker_used"]
    it, st = _hits(ot)
    ij, sj = _hits(oj)
    assert it == ij
    np.testing.assert_allclose(st, sj, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_routed_graph_matches_jax(metric):
    """Mixed route mask over raw vectors, exact candidates: the
    candidate gather (the gather kernel's path), both experts, the
    per-row select, the stable top-k."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((500, 32)).astype(np.float32) * rng.uniform(0.5, 2, (500, 1)).astype(np.float32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    route = np.array([True, False, True, False, False, True])
    sq = np.sum(x * x, axis=1, dtype=np.float32)
    valid = np.ones(500, bool)
    valid[-20:] = False
    vj, ij, rj = j_routed(
        jnp.asarray(q), jnp.asarray(route), jnp.asarray(x), jnp.asarray(sq),
        jnp.asarray(valid), k=7, candidates=40, n_qubits=4, metric=metric,
    )
    vt, it, rt = t_routed(
        torch.from_numpy(q), torch.from_numpy(route), torch.from_numpy(x),
        torch.from_numpy(sq), torch.from_numpy(valid), k=7, candidates=40,
        n_qubits=4, metric=metric,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("rtype", ["auto", "classical", "quantum"])
def test_search_rerank_types_match_jax(engines, rtype):
    je, te = engines
    for q in (TEXTS, TEXTS[1], _queries(2, 5)):
        _assert_same(
            te.search_rerank(q, k=10, candidates=100, reranker_type=rtype),
            je.search_rerank(q, k=10, candidates=100, reranker_type=rtype),
        )
    # no text to route on: "auto" reranks by fidelity and says so
    assert te.search_rerank(_queries(3, 2), reranker_type="auto")["reranker_used"] == "quantum"


@pytest.mark.parametrize("rtype", ["auto", "quantum", "classical"])
def test_engine_rerank_matches_jax(engines, rtype):
    je, te = engines
    for query in (TEXTS[0], TEXTS[1], ""):
        got = te.rerank(query, [TDoc(str(i), t) for i, t in enumerate(DOCS)], 3, rtype)
        want = je.rerank(query, [JDoc(str(i), t) for i, t in enumerate(DOCS)], 3, rtype)
        assert got["reranker_used"] == want["reranker_used"]
        assert [d.id for d, _ in got["documents"]] == [d.id for d, _ in want["documents"]]
        np.testing.assert_allclose(
            [s for _, s in got["documents"]], [s for _, s in want["documents"]], atol=1e-5
        )
    assert te.metrics.snapshot()["counters"]["rerank_requests"] >= 3


def test_pipelined_equals_search_rerank(engines):
    je, te = engines
    q = _queries(4, 7)
    got = te.search_rerank_pipelined(q, k=10, candidates=100, micro_batch=3)
    assert got == te.search_rerank(q, k=10, candidates=100)
    _assert_same(got, je.search_rerank_pipelined(q, k=10, candidates=100, micro_batch=3))
    with pytest.raises(ValueError):
        te.search_rerank_pipelined(q, reranker_type="classical")


def test_sample_recall_matches_jax(engines):
    je, te = engines
    assert te.sample_recall(k=10, samples=8, seed=3) == je.sample_recall(k=10, samples=8, seed=3) == 1.0
    np.testing.assert_array_equal(te.index.sample_rows([5, 1]), je.index.sample_rows([5, 1]))


def test_batcher_coalesces_and_matches_unbatched(engines):
    _, te = engines
    batcher = tbatcher.SearchBatcher(te, max_wait_s=0.05)
    q = _queries(5, 8)
    docs = [TDoc(str(i), t) for i, t in enumerate(DOCS)]
    try:
        with ThreadPoolExecutor(8) as pool:
            searches = [pool.submit(batcher.search, q[i : i + 1], k=3 + i % 2) for i in range(8)]
            reranks = [pool.submit(batcher.search_rerank, q[i], 5, 100) for i in range(4)]
            docrr = [pool.submit(batcher.rerank_documents, f"best ad deal {i}", docs, 2) for i in range(4)]
            searches = [f.result(timeout=120) for f in searches]
            reranks = [f.result(timeout=120) for f in reranks]
            docrr = [f.result(timeout=120) for f in docrr]
        for i, res in enumerate(searches):
            direct = te.search(q[i : i + 1], k=3 + i % 2)
            np.testing.assert_array_equal(res.indices, direct.indices)
            np.testing.assert_allclose(res.scores, direct.scores)
        for i, out in enumerate(reranks):
            assert out["results"] == te.search_rerank(q[i : i + 1], 5, 100)["results"]
        for i, out in enumerate(docrr):
            want = te.controller.rerank(f"best ad deal {i}", docs, 2, "quantum")
            assert out["reranker_used"] == "quantum"
            assert [(d.id, round(s, 5)) for d, s in out["documents"]] == [
                (d.id, round(s, 5)) for d, s in want["documents"]
            ]
        assert batcher.batches < 16 and batcher.stats()["batched_queries"] >= 12
        assert batcher.search(np.zeros((0, D), np.float32), k=5).indices.shape == (0, 5)
    finally:
        batcher.close()


def test_batcher_priority_and_close(engines):
    _, te = engines
    batcher = tbatcher.SearchBatcher(te, priority_aging_s=0.25)
    batcher._stop.set()
    with batcher._cv:
        batcher._cv.notify_all()
    batcher._worker.join(timeout=5)
    assert not batcher._worker.is_alive()
    items = []
    for prio, age in ((0, 0.0), (5, 0.0), (0, 0.0), (9, 0.0), (-2, 0.0), (0, 10.0)):
        it = tbatcher._Pending(vectors=np.zeros((1, D), np.float32), k=1, priority=prio)
        with batcher._cv:
            batcher._items.append((prio, next(batcher._seq), time.time() - age, it))
        items.append(it)
    drained = batcher._drain()
    # the priority-0 request that waited 10 s first (aging), then by
    # priority, FIFO within a level
    assert drained[0] is items[5]
    assert [it.priority for it in drained[1:]] == [9, 5, 0, 0, -2]
    assert batcher.prioritized_served == 2
    pending = tbatcher._Pending(vectors=np.zeros((1, D), np.float32), k=1)
    with batcher._cv:
        batcher._items.append((0, next(batcher._seq), time.time(), pending))
    batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        pending.future.result(timeout=5)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.search(np.zeros((1, D), np.float32), k=1)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("batching", [False, True])
def test_http_rerank_docs_stats(engines, batching):
    je, te = engines
    server = create_server(te, "127.0.0.1", 0, batching=batching, max_wait_s=0.05)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    body = {
        "query": TEXTS[0],
        "documents": [{"id": str(i), "content": t} for i, t in enumerate(DOCS)],
        "top_k": 3,
    }
    try:
        st, out = _post(port, "/rerank", body)
        want = je.rerank(TEXTS[0], [JDoc(str(i), t) for i, t in enumerate(DOCS)], 3)
        assert st == 200 and out["reranker_used"] == "quantum" == want["reranker_used"]
        assert [e["document"]["id"] for e in out["documents"]] == [d.id for d, _ in want["documents"]]
        st, out = _post(port, "/rerank", {**body, "reranker_type": "classical"})
        assert out["reranker_used"] == "classical" and len(out["documents"]) == 3
        st, out = _post(port, "/rerank", {"query": 42, "documents": []})
        assert st == 200 and out == {"error": "query must be a string"}
        st, out = _post(port, "/rerank", {"query": "q", "documents": "nope"})
        assert out == {"error": "documents must be a list"}
        st, docs = _get(port, "/docs")
        assert st == 200 and "POST /rerank" in docs["endpoints"]
        for rtype in ("auto", "classical"):
            st, out = _post(port, "/search_rerank", {"queries": TEXTS, "k": 5, "reranker_type": rtype})
            _assert_same(out, je.search_rerank(TEXTS, k=5, reranker_type=rtype))
        q = _queries(6, 4)
        with ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(
                lambda i: _post(port, "/search", {"vectors": [q[i].tolist()], "k": 3, "priority": 3}),
                range(4),
            ))
        for i, (st, out) in enumerate(outs):
            assert [h["index"] for h in out["results"][0]] == list(te.search(q[i : i + 1], k=3).indices[0])
        st, stats = _get(port, "/stats?recall=1")
        assert stats["sampled_recall_at_10"] == 1.0
        assert ("batcher" in stats) == batching
        if batching:
            assert stats["batcher"]["batched_queries"] >= 4
    finally:
        server.shutdown()
        server.server_close()
        if server.batcher is not None:
            server.batcher.close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_app_entry_and_batching_flag(monkeypatch):
    from qrag_tpu_torch.serving import app, http_app

    assert app.main is http_app.main
    seen = {}

    class _Stop(Exception):
        pass

    def fake_create(engine, host, port, batching=False, **kw):
        seen.update(batching=batching, **kw)
        raise _Stop

    monkeypatch.setattr(http_app, "create_server", fake_create)
    with pytest.raises(_Stop):
        http_app.main(["--batching", "--device", "cpu", "--no-warmup",
                       "--embedding-provider", "hash"])
    assert seen == {"batching": True, "max_pairs": 512}
