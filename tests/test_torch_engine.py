"""The port's slice as a whole: engine parity with the JAX engine on
one bundle (N=16384, d=128, hash embedder, candidates=100 so the
bounded large-k arm runs), the HTTP surface, and the no-jax import rule.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from qrag_tpu.config import QragConfig
from qrag_tpu.engine import QragEngine as JEngine
from qrag_tpu_torch.engine import QragEngine as TEngine
from qrag_tpu_torch.serving.http_app import create_server

N, D = 16384, 128
CFG = {"embedding": {"provider": "hash", "dim": D}}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A JAX-written engine bundle: N=16384 unit rows (normalized at
    ingestion by the default IndexConfig), d=128, hash embedder."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    eng = JEngine(config=QragConfig.from_dict(CFG))
    eng.index.add(x, [f"doc{i}" for i in range(N)])
    path = str(tmp_path_factory.mktemp("bundle"))
    eng.save(path)
    return path


@pytest.fixture(scope="module")
def engines(bundle):
    return JEngine.load(bundle), TEngine.load(bundle, device="cpu")


def _queries(seed, b):
    return np.random.default_rng(seed).standard_normal((b, D)).astype(np.float32)


def test_search_parity(engines):
    je, te = engines
    assert te.index._bounded_eligible(100)  # NW = 160 >= 100
    for q in (_queries(1, 8), ["find the advertisement", "a sponsor read"]):
        rj, rt = je.search(q, k=10), te.search(q, k=10)
        np.testing.assert_array_equal(rt.indices, rj.indices)
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-5, atol=1e-6)
        assert rt.metadata == rj.metadata


def _hits(out):
    idx = [[h["index"] for h in r] for r in out["results"]]
    score = [[h["score"] for h in r] for r in out["results"]]
    retr = [[h["retrieval_score"] for h in r] for r in out["results"]]
    return idx, np.asarray(score), np.asarray(retr)


def test_search_rerank_parity(engines):
    je, te = engines
    for q in (_queries(2, 6), "discount code offer"):
        oj = je.search_rerank(q, k=10, candidates=100)
        ot = te.search_rerank(q, k=10, candidates=100)
        assert ot["reranker_used"] == oj["reranker_used"] == "quantum"
        ij, sj, rj = _hits(oj)
        it, st, rt = _hits(ot)
        assert it == ij
        np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-6)
    on_j = je.search_rerank(_queries(3, 2), k=5, reranker_type="none")
    on_t = te.search_rerank(_queries(3, 2), k=5, reranker_type="none")
    assert on_t["reranker_used"] == "none" and _hits(on_t)[0] == _hits(on_j)[0]


def test_bundle_written_by_port_reads_in_jax(engines, tmp_path):
    _, te = engines
    te.save(str(tmp_path))
    je2 = JEngine.load(str(tmp_path))
    q = _queries(4, 3)
    np.testing.assert_array_equal(
        je2.search(q, k=10).indices, te.search(q, k=10).indices
    )


def test_unported_paths_raise(engines):
    _, te = engines
    for rtype in ("auto", "classical"):
        with pytest.raises(NotImplementedError):
            te.search_rerank(_queries(5, 1), reranker_type=rtype)
    for call in (te.rerank, te.search_rerank_pipelined):
        with pytest.raises(NotImplementedError):
            call("q", [])
    for over in ({"index": {"sharded": True}}, {"index": {"quantization": "int8"}},
                 {"embedding": {"provider": "trained", "dim": 8}}):
        with pytest.raises(NotImplementedError):
            TEngine(config=QragConfig.from_dict(over), device="cpu")


def test_stats_warmup_and_add(bundle):
    te = TEngine.load(bundle, device="cpu")
    assert te.warmup(batch_sizes=(1, 3)) > 0
    st = te.stats()
    assert st["backend"] == "cpu" and st["devices"] == ["cpu"]
    assert st["index"]["effective_topk_modes"] == {
        "search": "bounded", "fused_candidates": "bounded"
    }
    assert te.add_texts(["new text"], ["m"]) == N + 1
    assert te.search("new text", k=1).indices[0, 0] == N


def _call(port, path, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read().decode()
            return r.status, raw
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_surface(bundle):
    te = TEngine.load(bundle, device="cpu")
    server = create_server(te, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        st, raw = _call(port, "/")
        assert st == 200 and "endpoints" in json.loads(raw)
        q = _queries(6, 2)
        st, raw = _call(port, "/search", {"vectors": q.tolist(), "k": 4})
        body = json.loads(raw)
        assert st == 200 and body["metric"] == "l2"
        assert [h["index"] for h in body["results"][0]] == list(
            te.search(q, k=4).indices[0]
        )
        st, raw = _call(port, "/search", {"query": "sponsor", "k": 3})
        assert st == 200 and len(json.loads(raw)["results"][0]) == 3
        st, raw = _call(port, "/search", {"queries": ["a", "b"], "k": 2, "stream": True})
        lines = [json.loads(x) for x in raw.strip().splitlines()]
        assert st == 200 and lines[-1] == {"done": True, "metric": "l2"}
        assert len(lines) == 3
        st, raw = _call(port, "/search_rerank", {"vectors": q.tolist(), "k": 5, "candidates": 100})
        out = json.loads(raw)
        assert st == 200 and out["reranker_used"] == "quantum"
        assert out == json.loads(json.dumps(te.search_rerank(q, k=5, candidates=100)))
        st, raw = _call(port, "/rerank", {"query": "x", "documents": []})
        assert st == 501 and "not ported" in json.loads(raw)["error"]
        st, raw = _call(port, "/add", {"texts": ["fresh"]})
        assert json.loads(raw) == {"stored_count": 1, "total_vectors": N + 1}
        st, raw = _call(port, "/stats")
        assert st == 200 and json.loads(raw)["index"]["ntotal"] == N + 1
        st, _ = _call(port, "/nope")
        assert st == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_server_flags_not_ported():
    from qrag_tpu_torch.serving.http_app import main

    for flag in ("--batching", "--sharded", "--elastic"):
        with pytest.raises(SystemExit):
            main([flag])


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import qrag_tpu_torch, qrag_tpu_torch.engine, qrag_tpu_torch.serving\n"
        "import qrag_tpu_torch.ops.cuda.fused_scan, qrag_tpu_torch.index\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env)
