"""The port's rerankers and routing controller against the JAX
package's (``qrag_tpu.reranker``): the routing truth table with its
quirks, classical cosine scores (rtol 1e-5), neutral scores on invalid
input, the score cache, tie order, quantum fidelity scores (atol 1e-6),
the response schema, and what is refused.
"""

import json

import numpy as np
import pytest

from qrag_tpu import config as jconfig
from qrag_tpu.documents import Document as JDoc
from qrag_tpu.reranker import ClassicalReranker as JClassical
from qrag_tpu.reranker import QuantumReranker as JQuantum
from qrag_tpu.reranker import RerankerController as JController
from qrag_tpu.reranker.controller import rerank_response_dict as j_response
from qrag_tpu_torch import config as tconfig
from qrag_tpu_torch.documents import Document as TDoc
from qrag_tpu_torch.documents import validate_documents
from qrag_tpu_torch.reranker import (
    ClassicalReranker,
    QuantumReranker,
    RerankerController,
    rerank_response_dict,
)
from qrag_tpu_torch.reranker.classical import sanitize_text

_TEXTS = [
    "document number 0 text",
    "buy the product now great deal",
    "the weather is nice today",
    "sponsored by acme corp",
    "  spaced   out\n\tcontent  ",
    "x" * 5000,
]


def _docs(cls, texts=_TEXTS):
    return [cls(id=str(i), content=t, source="s") for i, t in enumerate(texts)]


def _pairs(out):
    return [(d.id, s) for d, s in out]


@pytest.mark.parametrize(
    "query",
    [
        "what is the weather today",
        "one two three four five six seven eight nine",
        "one two three four five six seven eight",  # strict >
        "find the sponsor segment",
        "please add numbers",  # "add" contains "ad"
        "brand new show",
        "discount codes here",
        "",
        "PROMO in caps",
    ],
)
def test_routing_truth_table(query):
    assert RerankerController(device="cpu").select_reranker(query) == JController().select_reranker(query)


def test_classical_cosine_scores_match():
    tr, jr = ClassicalReranker(device="cpu"), JClassical()
    for query in ("find the advertisement", "weather"):
        got, want = tr.rerank(query, _docs(TDoc), 4), jr.rerank(query, _docs(JDoc), 4)
        assert [d for d, _ in _pairs(got)] == [d for d, _ in _pairs(want)]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5)
    assert sanitize_text("  a \n\t b  ") == "a b" and len(sanitize_text("x" * 5000)) == 2048


def test_classical_neutral_cache_and_ties():
    rr = ClassicalReranker(device="cpu")
    out = rr.rerank("", _docs(TDoc))
    assert _pairs(out) == [(str(i), 0.5) for i in range(len(_TEXTS))]
    assert rr.rerank("ok", []) == [] and not validate_documents("ok", [TDoc("a", "")])
    calls = []

    def counting(query, contents):
        calls.append(len(contents))
        return np.linspace(0.1, 0.9, len(contents))

    cached = ClassicalReranker(scorer=counting, device="cpu")
    cached.rerank("q", _docs(TDoc))
    cached.rerank("q", _docs(TDoc))  # served from the cache
    assert calls == [len(_TEXTS)]
    flat = ClassicalReranker(scorer=lambda q, c: np.full(len(c), 0.7), device="cpu")
    assert [d.id for d, _ in flat.rerank("q", _docs(TDoc))] == [str(i) for i in range(len(_TEXTS))]


def test_classical_retries_then_neutral():
    calls = []

    def failing(query, contents):
        calls.append(1)
        raise RuntimeError("down")

    cfg = tconfig.ClassicalConfig(max_retries=2)
    out = ClassicalReranker(cfg, scorer=failing, device="cpu").rerank("query", _docs(TDoc)[:2])
    assert len(calls) == 2 and all(s == 0.5 for _, s in out)


def test_quantum_scores_match():
    tr, jr = QuantumReranker(device="cpu"), JQuantum()
    for query in ("detect the advertisement", "some query about sponsors"):
        np.testing.assert_allclose(
            tr.score_documents(query, _docs(TDoc)),
            jr.score_documents(query, _docs(JDoc)),
            atol=1e-6,
        )
        got, want = tr.rerank(query, _docs(TDoc), 3), jr.rerank(query, _docs(JDoc), 3)
        assert [d for d, _ in _pairs(got)] == [d for d, _ in _pairs(want)]
    assert tr.rerank("query", []) == []


def test_quantum_flat_scores_and_fallback():
    flat = QuantumReranker(tconfig.QuantumConfig(method="other"), device="cpu")
    assert all(s == 0.5 for _, s in flat.rerank("query", _docs(TDoc)))

    def broken(texts):
        raise RuntimeError("boom")

    calls = []

    class Spy(ClassicalReranker):
        def rerank(self, query, documents, top_k=None):
            calls.append(query)
            return super().rerank(query, documents, top_k)

    rr = QuantumReranker(embedder=broken, classical_fallback=Spy(device="cpu"), device="cpu")
    assert len(rr.rerank("query text", _docs(TDoc)[:3])) == 3 and calls == ["query text"]


@pytest.mark.parametrize("reranker_type", ["auto", "quantum", "classical"])
def test_controller_rerank_and_response_dict(reranker_type):
    query = "find the advertisement in this podcast"
    got = RerankerController(device="cpu").rerank(query, _docs(TDoc), 3, reranker_type)
    want = JController().rerank(query, _docs(JDoc), 3, reranker_type)
    assert got["reranker_used"] == want["reranker_used"] and got["query"] == query
    gd, wd = rerank_response_dict(got), j_response(want)
    json.dumps(gd)
    assert [e["document"] for e in gd["documents"]] == [e["document"] for e in wd["documents"]]
    np.testing.assert_allclose(
        [e["score"] for e in gd["documents"]], [e["score"] for e in wd["documents"]], atol=1e-5
    )


def test_unported_scorers_raise():
    # the cross-encoder scorer is ported: it builds (lazily) and is routed to
    ctl = RerankerController(
        tconfig.QragConfig.from_dict({"classical": {"method": "cross-encoder"}}), device="cpu"
    )
    assert ctl.classical_reranker._active_method == "cross-encoder"
    assert ctl.quantum_reranker.classical_fallback is ctl.classical_reranker
    # the amplitude encoding and the full statevector are ported: they
    # score (no fallback to classical) as the reference does
    for kw in ({"encoding": "amplitude"}, {"use_analytic_fidelity": False}):
        got = QuantumReranker(tconfig.QuantumConfig(**kw), device="cpu").rerank("query", _docs(TDoc))
        want = JQuantum(jconfig.QuantumConfig(**kw)).rerank("query", _docs(JDoc))
        assert [d.id for d, _ in got] == [d.id for d, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)
    assert jconfig.ClassicalConfig().method == tconfig.ClassicalConfig().method == "cosine"
