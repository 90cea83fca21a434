"""Parity of the port's int8 index modes with the JAX reference, on the
CPU: ``QuantizedFlatIndex`` (row, window, lean, domain_exact) and
``DeviceFlatIndex(bounded_scan="int8")`` through ``search``, appends
included; ``QragEngine`` with each config over HTTP; the int8 serving
flags and their refusals.

Same numpy inputs to both packages; indices must be equal, scores to
rtol 1e-5 (exact-score modes) or the reference's own score tolerance.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from qrag_tpu.config import QragConfig as JConfig
from qrag_tpu.engine import QragEngine as JEngine
from qrag_tpu.index.flat_index import DeviceFlatIndex as JIndex
from qrag_tpu.index.quantized_index import QuantizedFlatIndex as JQIndex
from qrag_tpu_torch.config import QragConfig
from qrag_tpu_torch.engine import QragEngine as TEngine
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex as TIndex
from qrag_tpu_torch.index.quantized_index import QuantizedFlatIndex as TQIndex
from qrag_tpu_torch.serving import http_app


def _data(seed, n, d, b):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, b)] + 0.2 * rng.standard_normal((b, d)).astype(np.float32)
    return x, q.astype(np.float32)


def _same(ti, ji, q, k, rtol=1e-5, atol=1e-5):
    rt, rj = ti.search(q, k=k), ji.search(q, k=k)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=rtol, atol=atol)
    assert rt.metadata == rj.metadata
    return rt


QMODES = {
    "row": dict(scan="row"),
    "window": dict(scan="window"),
    "lean": dict(scan="window", exact_scores=False),
    "domain_exact": dict(scan="window", domain_exact=True),
}


@pytest.mark.parametrize("mode", list(QMODES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_quantized_index_parity_with_append(mode, metric):
    n = 16384
    x, q = _data(0, n, 96, 6)
    extra = _data(1, 900, 96, 1)[0]
    meta = [f"m{i}" for i in range(n)]
    kw = dict(metric=metric, metadata=meta, **QMODES[mode])
    ti = TQIndex.from_numpy(x, device="cpu", **kw)
    ji = JQIndex.from_numpy(x, **kw)
    assert ti.layout() == ji.layout()
    assert ti.device_buffers().matrix.shape == tuple(ji.device_buffers().matrix.shape)
    # 160 windows: the windowed scan (not the small-corpus exact route)
    assert ti.device_buffers().matrix.shape[0] // 128 >= 16 * 10
    _same(ti, ji, q, 10)
    cap = ti.device_buffers().matrix.shape[0]
    ti.add(extra, [f"e{i}" for i in range(900)])
    ji.add(extra, [f"e{i}" for i in range(900)])
    snap = ti.device_buffers()
    assert snap.matrix.shape[0] == cap  # appended within capacity
    key = "int8" if mode == "row" else "int8w"
    assert snap.extras[key][0].shape[0] == cap  # fresh quantized forms
    res = _same(ti, ji, np.concatenate([q, extra[:3]]), 10)
    assert (res.indices[-3:, 0] == n + np.arange(3)).all()
    assert (ti.fallback_rows, ti.bounded_escalations) == (
        ji.fallback_rows, ji.bounded_escalations
    )


def test_quantized_index_small_corpus_and_validation():
    x, q = _data(2, 600, 40, 3)
    for mode in ("window", "domain_exact"):
        ti = TQIndex.from_numpy(x, device="cpu", **QMODES[mode])
        ji = JQIndex.from_numpy(x, **QMODES[mode])
        _same(ti, ji, q, 5)  # routes to the exact scan / full own-domain sort
    for bad in (dict(scan="nope"), dict(scan="row", exact_scores=False),
                dict(scan="row", domain_exact=True),
                dict(scan="window", row_pad_multiple=64)):
        with pytest.raises(ValueError):
            TQIndex(d=40, device="cpu", **bad)
    assert TQIndex(d=40, device="cpu", scan="window").row_pad_multiple == 1024
    # the base index takes "approx" too, with the JAX index's hits
    _same(TIndex.from_numpy(x, topk_mode="approx", device="cpu"),
          JIndex.from_numpy(x, topk_mode="approx"), q, 5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bounded_int8_index_parity(metric):
    x, q = _data(3, 16384, 100, 8)  # d=100: codes carry zero columns to 112
    extra = _data(4, 300, 100, 1)[0]
    kw = dict(metric=metric, bounded_scan="int8")
    ti = TIndex.from_numpy(x, device="cpu", **kw)
    ji = JIndex.from_numpy(x, **kw)
    assert ti._bounded_eligible(10)
    _same(ti, ji, q, 10)
    ti.add(extra)
    ji.add(extra)
    _same(ti, ji, np.concatenate([q, extra[:2]]), 10)
    q8x = ti._bounded_buffers_int8()[1][0]
    assert q8x.shape[1] == 112 and not q8x[:, 100:].any()
    assert (ti.fallback_rows, ti.bounded_escalations) == (
        ji.fallback_rows, ji.bounded_escalations
    )
    tf = TIndex.from_numpy(x, device="cpu", metric=metric, bounded_scan="int8",
                           store_dtype="bfloat16", bounded_query_dtype="store")
    jf = JIndex.from_numpy(x, metric=metric, bounded_scan="int8",
                           store_dtype="bfloat16", bounded_query_dtype="store")
    _same(tf, jf, q, 10)


# ------------------------------------------------------------------- engine

N, D = 16384, 64
ENGINE_CFGS = {
    "bounded_int8": {"index": {"bounded_scan": "int8"}},
    "quant_row": {"index": {"quantization": "int8"}},
    "quant_window": {"index": {"quantization": "int8", "quant_scan": "window"}},
    "lean": {"index": {"quantization": "int8", "quant_scan": "window",
                       "exact_scores": False}},
}


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    return rng.standard_normal((N, D)).astype(np.float32)


@pytest.mark.parametrize("name", list(ENGINE_CFGS))
def test_engine_http_parity(name, corpus):
    over = dict(ENGINE_CFGS[name], embedding={"provider": "hash", "dim": D})
    je = JEngine(config=JConfig.from_dict(over))
    te = TEngine(config=QragConfig.from_dict(over), device="cpu")
    je.index.add(corpus)
    te.index.add(corpus)
    q = np.random.default_rng(6).standard_normal((5, D)).astype(np.float32)
    server = http_app.create_server(te, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        for body in ({"vectors": q.tolist(), "k": 10}, {"query": "sponsor read", "k": 10}):
            got = _post(port, "/search", body)
            ref = je.search(np.asarray(body["vectors"], np.float32)
                            if "vectors" in body else [body["query"]], k=10)
            assert [[h["index"] for h in r] for r in got["results"]] == ref.indices.tolist()
            np.testing.assert_allclose(
                [[h["score"] for h in r] for r in got["results"]], ref.scores,
                rtol=1e-5, atol=1e-5,
            )
        rr = _post(port, "/search_rerank", {"vectors": q.tolist(), "k": 5, "candidates": 100})
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    jstats = je.stats()["index"]
    # the fused rerank runs on every index now (the quantized ones take
    # their candidates from the store matrix in "approx", as JAX does)
    jr = je.search_rerank(q, k=5, candidates=100)
    assert [[h["index"] for h in r] for r in rr["results"]] == [
        [h["index"] for h in r] for r in jr["results"]]
    np.testing.assert_allclose(
        [[h["score"] for h in r] for r in rr["results"]],
        [[h["score"] for h in r] for r in jr["results"]], rtol=1e-5, atol=1e-6,
    )
    assert stats["index"]["effective_topk_modes"] == jstats["effective_topk_modes"]
    if name == "bounded_int8":
        assert stats["index"]["effective_topk_modes"]["fused_candidates"] == "bounded"
        assert "layout" not in stats["index"]
    else:
        assert stats["index"]["layout"] == jstats["layout"]
        none = te.search_rerank(q, k=5, reranker_type="none")
        assert none["reranker_used"] == "none"
        assert [[h["index"] for h in r] for r in none["results"]] == (
            je.search(q, k=5).indices.tolist())
        assert te.warmup(batch_sizes=(2,)) > 0  # the fused rerank warms too
    assert stats["index"]["topk_mode"] == jstats["topk_mode"]


# ---------------------------------------------------------------- CLI flags


_CLI_ENV = ("QRAG_INDEX_TOPK_MODE", "QRAG_INDEX_BOUNDED_SCAN",
            "QRAG_INDEX_BOUNDED_QUERY_DTYPE", "QRAG_INDEX_QUANTIZATION",
            "QRAG_INDEX_QUANT_SCAN", "QRAG_INDEX_EXACT_SCORES")


def _configure(monkeypatch, argv):
    """``http_app._configure`` on a clean env channel.  It writes its
    choices into ``os.environ`` for bundle reloads; ``delenv`` alone
    records nothing for a variable that is not set, so what
    ``_configure`` wrote would outlive the test and reach every later
    ``QragEngine.load`` of the process.  ``setenv`` first makes
    monkeypatch record the variable as absent and remove it again."""
    for var in _CLI_ENV:
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    parser = http_app._parser()
    return http_app._configure(parser, parser.parse_args(argv))


def test_cli_int8_flags(monkeypatch):
    cfg = _configure(monkeypatch, ["--bounded-scan", "int8",
                                   "--bounded-query-dtype", "store"])
    assert (cfg.index.topk_mode, cfg.index.bounded_scan,
            cfg.index.bounded_query_dtype) == ("bounded", "int8", "store")
    # the env channel carries them into engine bundles (QragEngine.load)
    env = QragConfig().with_env_overrides()
    assert (env.index.bounded_scan, env.index.bounded_query_dtype) == ("int8", "store")
    cfg = _configure(monkeypatch, ["--lean-scan"])
    assert (cfg.index.quantization, cfg.index.quant_scan,
            cfg.index.exact_scores) == ("int8", "window", False)
    env = QragConfig().with_env_overrides()
    assert (env.index.quantization, env.index.quant_scan,
            env.index.exact_scores) == ("int8", "window", False)
    assert TEngine(config=cfg, device="cpu").index.layout()["exact_scores"] is False


@pytest.mark.parametrize("argv", [
    ["--lean-scan", "--topk-mode", "bounded"],
    ["--topk-mode", "exact", "--bounded-scan", "int8"],
    ["--topk-mode", "exact", "--bounded-query-dtype", "store"],
    ["--bounded-scan", "int4"],
])
def test_cli_int8_flag_refusals(monkeypatch, argv):
    with pytest.raises(SystemExit):
        _configure(monkeypatch, argv)


def test_cli_flags_leave_the_env_channel_as_found():
    """What ``_configure`` exports must not outlive the test that called
    it: a leaked QRAG_INDEX_QUANTIZATION=int8 makes every later
    ``QragEngine.load`` in the process build a quantized index."""
    before = {v: os.environ.get(v) for v in _CLI_ENV}
    with pytest.MonkeyPatch.context() as mp:
        _configure(mp, ["--bounded-scan", "int8", "--bounded-query-dtype", "store"])
        _configure(mp, ["--lean-scan"])
        assert os.environ["QRAG_INDEX_QUANTIZATION"] == "int8"
    assert {v: os.environ.get(v) for v in _CLI_ENV} == before
