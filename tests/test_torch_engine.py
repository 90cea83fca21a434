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
from qrag_tpu_torch.documents import Document
from qrag_tpu_torch.engine import QragEngine as TEngine
from qrag_tpu_torch.serving.http_app import create_server

N, D = 16384, 128
CFG = {"embedding": {"provider": "hash", "dim": D}}


@pytest.fixture(scope="module", autouse=True)
def _clean_env_channel():
    """Both engines' ``load`` re-read QRAG_* overrides from the
    environment.  A serve CLI driven by an earlier test of the same
    process exports its index choices there; this module's engines must
    be the bundle's own, whatever ran before."""
    saved = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("QRAG_")}
    yield
    os.environ.update(saved)


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
    je, te = engines
    # the sharded index is ported: over the bundle's rows on 4 cpu slots
    # it answers as the unsharded engines do
    sh_cfg = QragConfig.from_dict(
        {**CFG, "index": {"sharded": True}, "mesh": {"model_parallel": 4}}
    )
    sharded = TEngine(config=sh_cfg, device="cpu")
    sharded.index.add(te.index._host_vectors, te.index.metadata)
    assert sharded.index.layout()["mesh"] == {"data": 1, "model": 4}
    q = _queries(8, 3)
    np.testing.assert_array_equal(sharded.search(q, k=10).indices, je.search(q, k=10).indices)
    # the trained embedder and the cross-encoder scorer are ported now
    trained = TEngine(config=QragConfig.from_dict(
        {"embedding": {"provider": "trained", "dim": 8},
         "classical": {"method": "cross-encoder"}}), device="cpu")
    assert trained.embedder(["text"]).shape == (1, 8)
    assert trained.controller.classical_reranker._active_method == "cross-encoder"
    # the full-statevector fidelity is ported: the fused rerank (direct
    # and pipelined) and the doc-list rerank equal the JAX engine's
    sv_cfg = {**CFG, "quantum": {"use_analytic_fidelity": False}}
    te_sv = TEngine(config=QragConfig.from_dict(sv_cfg), index=te.index, device="cpu")
    je_sv = JEngine(config=QragConfig.from_dict(sv_cfg), index=engines[0].index)
    q = _queries(5, 2)
    ot, oj = te_sv.search_rerank(q), je_sv.search_rerank(q)
    assert ot["reranker_used"] == oj["reranker_used"] == "quantum"
    assert _hits(ot)[0] == _hits(oj)[0]
    np.testing.assert_allclose(_hits(ot)[1], _hits(oj)[1], atol=1e-6)
    assert _hits(te_sv.search_rerank_pipelined(q))[0] == _hits(ot)[0]
    out = te_sv.rerank("find the ad", [Document("a", "text")], reranker_type="quantum")
    assert out["reranker_used"] == "quantum"
    # the fused reranks over a quantized index: candidates from the bf16
    # store in the index's "approx" mode, as the JAX engine takes them —
    # 64 rows (the exact sort) and 6,000 (the scan_topk selection)
    q_cfg = QragConfig.from_dict(
        {"index": {"quantization": "int8"}, "embedding": {"provider": "hash", "dim": D}}
    )
    for rows in (64, 6000):
        quant = TEngine(config=q_cfg, device="cpu")
        jquant = JEngine(config=q_cfg)
        quant.index.add(_queries(7, rows))
        jquant.index.add(_queries(7, rows))
        texts = ["find the ad", "hello there"]
        for rtype in ("quantum", "auto", "classical"):
            ot = quant.search_rerank(texts, reranker_type=rtype)
            oj = jquant.search_rerank(texts, reranker_type=rtype)
            assert ot["reranker_used"] == oj["reranker_used"] == rtype
            assert _hits(ot)[0] == _hits(oj)[0]
            # fidelities / cosines: f32 sums in another order
            np.testing.assert_allclose(_hits(ot)[1], _hits(oj)[1], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(_hits(ot)[2], _hits(oj)[2], rtol=1e-5, atol=1e-4)
        qv = _queries(9, 5)
        ot, oj = quant.search_rerank_pipelined(qv, micro_batch=2), jquant.search_rerank_pipelined(qv, micro_batch=2)
        assert _hits(ot)[0] == _hits(oj)[0]
        np.testing.assert_allclose(_hits(ot)[1], _hits(oj)[1], rtol=1e-5, atol=1e-6)
    assert quant.stats()["index"]["effective_topk_modes"] == {
        "search": "approx", "fused_candidates": "approx", "pipelined_stage1": "approx"
    }
    with pytest.raises(ValueError):
        te.search_rerank(_queries(5, 1), reranker_type="bogus")


def test_stats_warmup_and_add(bundle):
    te = TEngine.load(bundle, device="cpu")
    assert te.warmup(batch_sizes=(1, 3)) > 0
    st = te.stats()
    assert st["backend"] == "cpu" and st["devices"] == ["cpu"]
    assert st["index"]["effective_topk_modes"] == {
        "search": "bounded", "fused_candidates": "bounded", "pipelined_stage1": "bounded"
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
        assert st == 200 and json.loads(raw) == {
            "documents": [], "reranker_used": "classical", "query": "x"
        }
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


def test_server_flags_not_ported(monkeypatch):
    """The sharded flags are ported: they select the sharded (elastic)
    index and write the env channel; the reference's parser errors stand."""
    from qrag_tpu_torch.serving.http_app import _configure, _parser

    # _configure writes the env channel: give it a scratch copy
    monkeypatch.setattr(
        os, "environ", {k: v for k, v in os.environ.items() if not k.startswith("QRAG_")}
    )
    parser = _parser()
    for bad in (["--elastic"], ["--shard-merge", "ring"], ["--sharded", "--lean-scan"],
                ["--sharded", "--bounded-scan", "int8"]):
        with pytest.raises(SystemExit):
            _configure(parser, parser.parse_args(bad))
    cfg = _configure(parser, parser.parse_args(["--sharded", "--shard-merge", "ring", "--elastic"]))
    assert (cfg.index.sharded, cfg.index.shard_merge, cfg.index.elastic) == (True, "ring", True)
    assert os.environ["QRAG_INDEX_SHARD_MERGE"] == "ring"
    assert os.environ["QRAG_INDEX_SHARDED"] == os.environ["QRAG_INDEX_ELASTIC"] == "1"
    del os.environ["QRAG_INDEX_ELASTIC"]
    cfg = _configure(parser, parser.parse_args(["--sharded", "--topk-mode", "verified"]))
    assert (cfg.index.shard_merge, cfg.index.elastic, cfg.index.topk_mode) == (
        "ring", False, "verified"
    )


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py, bench_torch.py and the
    ported examples and scripts, imported in a fresh interpreter: neither
    jax, nor anything of the JAX package, nor
    pydantic, optax, orbax or flax loads.  The package and its
    re-exporting subpackages load no kernel wrapper and no
    ``torch.utils.cpp_extension`` (kernels build at first launch)."""
    code = (
        "import pkgutil, sys\n"
        "import qrag_tpu_torch, qrag_tpu_torch.ops, qrag_tpu_torch.index\n"
        "import qrag_tpu_torch.serving\n"
        "built = [m for m in sys.modules if m.startswith('qrag_tpu_torch.ops.cuda')\n"
        "         or m.startswith('torch.utils.cpp_extension')]\n"
        "assert not built, built\n"
        "import chip_smoke, bench_torch, importlib.util\n"
        "for path in ('examples/full_workflow_torch.py',\n"
        "             'examples/latency_mode_demo_torch.py',\n"
        "             'examples/sharded_streaming_demo_torch.py',\n"
        "             'scripts/eval_distilled_torch.py', 'scripts/accel_real_embed_torch.py'):\n"
        "    spec = importlib.util.spec_from_file_location(path[:-3].replace('/', '.'), path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    qrag_tpu_torch.__path__, 'qrag_tpu_torch.')]\n"
        "for name in names:\n"
        "    __import__(name)\n"
        "assert len(names) >= 20, names\n"
        "new = {'documents', 'reranker', 'reranker.classical', 'reranker.quantum',\n"
        "       'reranker.controller', 'serving.batcher', 'serving.app',\n"
        "       'ops.gather_rows', 'ops.scan_topk', 'ops.cuda.gather_rows',\n"
        "       'ops.cuda.scan_topk', 'ops.cuda._launch', 'ops.cuda.launch_ab',\n"
        "       'models.cross_encoder', 'models.bi_encoder', 'models.weights',\n"
        "       'pipeline.storage', 'pipeline.corpus_gen', 'tools.interface',\n"
        "       'tools.progress', 'tools.service', 'tools.ingest_tools',\n"
        "       'serving.mcp_server', 'serving.mcp_client', 'serving.llm_orchestrator',\n"
        "       'serving.devreload', 'parallel', 'parallel.train', 'models.checkpoint',\n"
        "       'models.train_cli', 'models.recall_eval', 'models.rerank_eval',\n"
        "       'models.distill', 'ops.cluster_topk', 'ops.circuit',\n"
        "       'index.native_store', 'utils.profiling', 'parallel.mesh',\n"
        "       'parallel.sharded_index', 'parallel.elastic', 'parallel.collectives',\n"
        "       'models.sequence_parallel', 'ops', 'index', 'serving'}\n"
        "assert {'qrag_tpu_torch.' + m for m in new} <= set(names), names\n"
        "banned = ('jax', 'qrag_tpu', 'pydantic', 'optax', 'orbax', 'flax')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env)


def test_framework_free_copies_match_reference():
    """The port's own copies of config, embeddings, chunker and metrics
    behave as the reference modules do."""
    from qrag_tpu import config as jconfig
    from qrag_tpu.pipeline import chunker as jchunk
    from qrag_tpu.pipeline import embeddings as jemb
    from qrag_tpu_torch import config as tconfig
    from qrag_tpu_torch.pipeline import chunker as tchunk
    from qrag_tpu_torch.pipeline import embeddings as temb
    from qrag_tpu_torch.utils.metrics import Metrics

    over = {"index": {"quantization": "int8", "quant_scan": "window",
                      "refine_factor": 6}, "serving": {"doc_buckets": [4, 8]},
            "embedding": {"provider": "hash", "dim": 96}, "unknown": {"x": 1}}
    env = {"QRAG_INDEX_EXACT_SCORES": "0", "QRAG_SERVING_PORT": "9100",
           "QRAG_QUANTUM_N_QUBITS": "6", "QRAG_SERVING_WARMUP_BATCH_BUCKETS": "1,4",
           "QRAG_CONTROLLER_QUANTUM_KEYWORDS": "ad, promo"}
    for d in (None, {}, over):
        tj = jconfig.QragConfig.from_dict(d).with_env_overrides(env)
        tt = tconfig.QragConfig.from_dict(d).with_env_overrides(env)
        assert tt.to_dict() == tj.to_dict()
    texts = ["find the advertisement", "", "a sponsor read " * 40]
    for provider, dim in (("hash", 64), ("mock", 8), ("mock", 0)):
        ej = jemb.get_embedder(jconfig.EmbeddingConfig(provider=provider, dim=dim))
        et = temb.get_embedder(tconfig.EmbeddingConfig(provider=provider, dim=dim))
        np.testing.assert_array_equal(et(texts), ej(texts))
    long = ("word. " * 3000) + ("x" * 9000) + ("line\n" * 2000)
    for max_tokens in (100, 1000, 8000):
        assert tchunk.chunk_text(long, max_tokens) == jchunk.chunk_text(long, max_tokens)
    trained = tconfig.EmbeddingConfig(provider="trained", dim=32, model="none")
    ej = jemb.get_embedder(jconfig.EmbeddingConfig(provider="trained", dim=32, model="none"))
    et = temb.get_embedder(trained, device="cpu")
    assert et(texts).shape == ej(texts).shape == (3, 32)
    m = Metrics()
    with m.timer("search"):
        m.incr("requests", 2)
    snap = m.snapshot()
    assert snap["counters"] == {"requests": 2} and snap["latency"]["search"]["count"] == 1


def test_load_reads_env_overrides(bundle, monkeypatch):
    """The env channel is real: an exported index choice changes what
    ``load`` builds (so tests that drive the CLI must scrub it), and
    without one the bundle's own config stands."""
    from qrag_tpu_torch.index.quantized_index import QuantizedFlatIndex

    assert not isinstance(TEngine.load(bundle, device="cpu").index, QuantizedFlatIndex)
    monkeypatch.setenv("QRAG_INDEX_QUANTIZATION", "int8")
    monkeypatch.setenv("QRAG_INDEX_QUANT_SCAN", "window")
    assert isinstance(TEngine.load(bundle, device="cpu").index, QuantizedFlatIndex)
