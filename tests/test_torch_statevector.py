"""Parity of the port's full quantum paths with the JAX reference and
the independent Qiskit-convention oracle, on the CPU: the circuit API
(``ops.circuit``), the complex statevector, amplitude and swap-test ops
(``ops.statevector``), the reranker's amplitude and full-statevector
scores, the engine's fused full-statevector rerank, the batcher's pair
function, and the profiling helpers.

Complex statevectors agree with JAX within 1e-6 and with the oracle
(complex128) within 1e-6; fidelities within 1e-6.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.ops import circuit as jcirc
from qrag_tpu.ops import statevector as jsv
from qrag_tpu_torch.ops import circuit as tcirc
from qrag_tpu_torch.ops import statevector as tsv

sys.path.insert(0, os.path.dirname(__file__))
from oracle_qiskit import oracle_fidelity, oracle_statevector  # noqa: E402

QUBITS = range(1, 9)


def _vecs(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", QUBITS)
def test_encode_statevector_against_jax_and_oracle(n):
    v = _vecs(n, (4, 2 * n))
    v[3, :] = 0.0  # a zero vector passes through unnormalized
    got = tsv.encode_statevector(_t(v), n)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (4, 2 ** n)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsv.encode_statevector(jnp.asarray(v), n)), atol=1e-6)
    want = np.stack([oracle_statevector(x, n) for x in v])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    amps = tsv.encode_product_amplitudes(_t(v[:, : max(1, n // 2)]), n)  # short: |0> padding
    np.testing.assert_allclose(
        amps.numpy(),
        np.asarray(jsv.encode_product_amplitudes(jnp.asarray(v[:, : max(1, n // 2)]), n)),
        atol=1e-6,
    )


@pytest.mark.parametrize("n", QUBITS)
def test_gates_against_jax(n):
    rng = np.random.default_rng(100 + n)
    state = (rng.standard_normal((3, 2 ** n)) + 1j * rng.standard_normal((3, 2 ** n))).astype(np.complex64)
    u = (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))).astype(np.complex64)
    for q in range(n):
        np.testing.assert_allclose(
            tsv.apply_1q_gate(_t(state), _t(u), q, n).numpy(),
            np.asarray(jsv.apply_1q_gate(jnp.asarray(state), jnp.asarray(u), q, n)),
            atol=1e-6,
        )
    pairs = [(c, t) for c in range(n) for t in range(n) if c != t]
    if n > 4:  # every ordered pair up to 4 qubits; the ends and a middle pair past that
        pairs = [(0, n - 1), (n - 1, 0), (1, 2), (n // 2, 0), (n - 2, n - 1)]
    for c, t in pairs:
        np.testing.assert_array_equal(
            tsv.apply_cx(_t(state), c, t, n).numpy(),
            np.asarray(jsv.apply_cx(jnp.asarray(state), c, t, n)),
        )


@pytest.mark.parametrize("n", QUBITS)
def test_fidelities_against_jax_and_oracle(n):
    q = _vecs(200 + n, (2 * n,))
    docs = _vecs(300 + n, (6, 2 * n))
    sv = tsv.fidelity_statevector(_t(q), _t(docs), n)
    assert sv.dtype == torch.float32 and tuple(sv.shape) == (6,)
    np.testing.assert_allclose(
        sv.numpy(), np.asarray(jsv.fidelity_statevector(jnp.asarray(q), jnp.asarray(docs), n)), atol=1e-6
    )
    oracle = np.array([oracle_fidelity(q, d, n) for d in docs])
    np.testing.assert_allclose(sv.numpy(), oracle, atol=1e-6)
    for analytic in (True, False):
        np.testing.assert_allclose(
            tsv.batched_fidelity(_t(q), _t(docs), n, analytic=analytic).numpy(),
            np.asarray(jsv.batched_fidelity(jnp.asarray(q), jnp.asarray(docs), n, analytic)),
            atol=1e-6,
        )
    # state_fidelity on the encoded states
    np.testing.assert_allclose(
        tsv.state_fidelity(tsv.encode_statevector(_t(q), n)[None], tsv.encode_statevector(_t(docs), n)).numpy(),
        oracle, atol=1e-6,
    )


@pytest.mark.parametrize("n", QUBITS)
def test_amplitude_and_swap_test_against_jax(n):
    q = _vecs(400 + n, (2 ** n + 3,))  # truncated
    docs = _vecs(500 + n, (5, max(1, 2 ** n - 1)))  # zero-padded
    docs_full = _vecs(600 + n, (5, 2 ** n + 3))
    enc = tsv.amplitude_encode(_t(docs), n)
    assert enc.dtype == torch.complex64 and enc.shape[-1] == 2 ** n
    np.testing.assert_allclose(enc.numpy(), np.asarray(jsv.amplitude_encode(jnp.asarray(docs), n)), atol=1e-6)
    for fn in ("amplitude_fidelity", "swap_test_probability"):
        np.testing.assert_allclose(
            getattr(tsv, fn)(_t(q), _t(docs_full), n).numpy(),
            np.asarray(getattr(jsv, fn)(jnp.asarray(q), jnp.asarray(docs_full), n)),
            atol=1e-6,
        )
    qs = _vecs(700 + n, (3, 2 ** n))  # a query batch: (Q, N)
    np.testing.assert_allclose(
        tsv.amplitude_fidelity(_t(qs), _t(docs_full), n).numpy(),
        np.asarray(jsv.amplitude_fidelity(jnp.asarray(qs), jnp.asarray(docs_full), n)),
        atol=1e-6,
    )


def _circuits(mod, n, **kw):
    c = mod.Circuit(n, **kw).h(0).encode_rotations(_vecs(800 + n, (2 * n,)))
    c.cx_ladder().x(n - 1).z(0).ry(0.3, n // 2).rz(-0.7, 0)
    c.gate(np.array([[0, -1j], [1j, 0]]), n - 1)  # Y
    if n > 1:
        c.cx(n - 1, 0)
    return c


@pytest.mark.parametrize("n", QUBITS)
def test_circuit_against_jax_and_oracle(n):
    tc, jc = _circuits(tcirc, n, device="cpu"), _circuits(jcirc, n)
    np.testing.assert_allclose(tc.simulate().numpy(), np.asarray(jc.simulate()), atol=1e-6)
    np.testing.assert_allclose(tc.probabilities().numpy(), np.asarray(jc.probabilities()), atol=1e-6)
    for qubit in range(n):
        for value in (0, 1):
            np.testing.assert_allclose(
                float(tc.measure_probability(qubit, value)),
                float(jc.measure_probability(qubit, value)), atol=1e-6,
            )
    # batched initial states
    rng = np.random.default_rng(900 + n)
    st = (rng.standard_normal((2, 2 ** n)) + 1j * rng.standard_normal((2, 2 ** n))).astype(np.complex64)
    np.testing.assert_allclose(tc.simulate(_t(st)).numpy(), np.asarray(jc.simulate(jnp.asarray(st))), atol=1e-5)
    # the reference encoding as a circuit equals the oracle's statevector
    v = _vecs(1000 + n, (2 * n,))
    enc = tcirc.Circuit(n, device="cpu").encode_rotations(v).cx_ladder().simulate()
    np.testing.assert_allclose(enc.numpy(), oracle_statevector(v, n), atol=1e-6)


def test_circuit_default_state_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcirc.Circuit(2).h(0).simulate()
    assert tcirc.Circuit(2, device="cpu").h(0).simulate().device == torch.device("cpu")


# ------------------------------------------------------- reranker / engine


def _docs(cls, n=12):
    return [cls(str(i), f"document {i} about segment {i % 5} and sponsor {i % 3}") for i in range(n)]


@pytest.mark.parametrize("cfg", [{"encoding": "amplitude"}, {"use_analytic_fidelity": False},
                                 {"encoding": "amplitude", "n_qubits": 3},
                                 {"use_analytic_fidelity": False, "n_qubits": 6}])
def test_quantum_reranker_scores_against_jax(cfg):
    from qrag_tpu.config import QuantumConfig as JQC
    from qrag_tpu.documents import Document as JDoc
    from qrag_tpu.reranker.quantum import QuantumReranker as JQR
    from qrag_tpu_torch.config import QuantumConfig as TQC
    from qrag_tpu_torch.documents import Document as TDoc
    from qrag_tpu_torch.reranker.quantum import QuantumReranker as TQR

    tq, jq = TQR(TQC(**cfg), device="cpu"), JQR(JQC(**cfg))
    st = tq.score_documents("find the sponsor segment", _docs(TDoc))
    sj = jq.score_documents("find the sponsor segment", _docs(JDoc))
    np.testing.assert_allclose(st, sj, atol=1e-6)
    rt = tq.rerank("find the sponsor segment", _docs(TDoc), top_k=5)
    rj = jq.rerank("find the sponsor segment", _docs(JDoc), top_k=5)
    assert [d.id for d, _ in rt] == [d.id for d, _ in rj]
    np.testing.assert_allclose([s for _, s in rt], [s for _, s in rj], atol=1e-6)


@pytest.mark.parametrize("encoding,analytic", [("rotation", False), ("amplitude", True),
                                               ("rotation", True)])
def test_batcher_pair_function_against_jax(encoding, analytic):
    from qrag_tpu.serving.batcher import _pair_fidelity_fn as j_pair
    from qrag_tpu_torch.serving.batcher import _pair_fidelity_fn as t_pair

    for n in (2, 4, 5):
        q = _vecs(1100 + n, (9, 2 * n + 1))
        d = _vecs(1200 + n, (9, 2 * n + 1))
        got = t_pair(n, analytic, encoding)(_t(q), _t(d))
        assert tuple(got.shape) == (9,)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(j_pair(n, analytic, encoding)(jnp.asarray(q), jnp.asarray(d))), atol=1e-6
        )


N, D = 8192, 32


@pytest.fixture(scope="module")
def sv_engines():
    """A JAX and a port engine over one corpus with the full-statevector
    fidelity (n_qubits 5): candidates from the bounded scan."""
    from qrag_tpu.config import QragConfig as JConfig
    from qrag_tpu.engine import QragEngine as JEngine
    from qrag_tpu_torch.config import QragConfig as TConfig
    from qrag_tpu_torch.engine import QragEngine as TEngine

    cfg = {"embedding": {"provider": "hash", "dim": D},
           "quantum": {"use_analytic_fidelity": False, "n_qubits": 5}}
    x = _vecs(1300, (N, D))
    meta = [f"d{i}" for i in range(N)]
    je, te = JEngine(config=JConfig.from_dict(cfg)), TEngine(config=TConfig.from_dict(cfg), device="cpu")
    je.index.add(x, meta)
    te.index.add(x, meta)
    return je, te


def _hits(out):
    return ([[h["index"] for h in r] for r in out["results"]],
            np.asarray([[h["score"] for h in r] for r in out["results"]]))


def test_engine_fused_statevector_rerank_against_jax(sv_engines):
    je, te = sv_engines
    for q in (_vecs(1400, (6, D)), "a sponsor read"):
        oj, ot = je.search_rerank(q, k=10, candidates=64), te.search_rerank(q, k=10, candidates=64)
        assert ot["reranker_used"] == oj["reranker_used"] == "quantum"
        ij, sj = _hits(oj)
        it, st = _hits(ot)
        assert it == ij
        np.testing.assert_allclose(st, sj, atol=1e-6)
    # the statevector path and the analytic one agree on the same candidates
    from qrag_tpu_torch.engine import fused_search_rerank

    snap = te.index.device_buffers()
    q = _t(_vecs(1401, (3, D)))
    common = dict(k=10, candidates=64, n_qubits=5, metric="l2")
    fa, ia, _ = fused_search_rerank(q, snap.matrix, snap.sqnorms, snap.valid,
                                    fid_feats=te.index.fidelity_features(5, snap), **common)
    fs, is_, _ = fused_search_rerank(q, snap.matrix, snap.sqnorms, snap.valid, analytic=False, **common)
    np.testing.assert_array_equal(is_.numpy(), ia.numpy())
    np.testing.assert_allclose(fs.numpy(), fa.numpy(), atol=1e-6)


def test_engine_statevector_pipelined_and_doc_rerank(sv_engines):
    je, te = sv_engines
    q = _vecs(1500, (5, D))
    out = te.search_rerank_pipelined(q, k=10, candidates=64, micro_batch=2)
    assert _hits(out)[0] == _hits(te.search_rerank(q, k=10, candidates=64))[0]
    from qrag_tpu.documents import Document as JDoc
    from qrag_tpu_torch.documents import Document as TDoc

    rt = te.rerank("find the ad", _docs(TDoc), reranker_type="quantum")
    rj = je.rerank("find the ad", _docs(JDoc), reranker_type="quantum")
    assert rt["reranker_used"] == rj["reranker_used"] == "quantum"
    assert [d.id for d, _ in rt["documents"]] == [d.id for d, _ in rj["documents"]]
    assert te.warmup(batch_sizes=[1]) >= 0


def test_batcher_coalesces_statevector_and_amplitude_reranks():
    """Concurrent /rerank requests coalesce into one pair call of the
    configured encoding and equal the single-request reranker."""
    import threading

    from qrag_tpu_torch.config import QragConfig as TConfig
    from qrag_tpu_torch.documents import Document as TDoc
    from qrag_tpu_torch.engine import QragEngine as TEngine
    from qrag_tpu_torch.serving.batcher import SearchBatcher

    for quantum in ({"use_analytic_fidelity": False}, {"encoding": "amplitude"}):
        eng = TEngine(config=TConfig.from_dict({"embedding": {"provider": "hash", "dim": D},
                                                "quantum": quantum}), device="cpu")
        batcher = SearchBatcher(eng, max_wait_s=0.05)
        try:
            queries = ["find the sponsor", "the ad read", "segment three"]
            out = [None] * len(queries)

            def run(i):
                out[i] = batcher.rerank_documents(queries[i], _docs(TDoc, 7 + i), top_k=4,
                                                  reranker_type="quantum")

            threads = [threading.Thread(target=run, args=(i,)) for i in range(len(queries))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            for i, q in enumerate(queries):
                want = eng.controller.quantum_reranker.rerank(q, _docs(TDoc, 7 + i), top_k=4)
                assert out[i]["reranker_used"] == "quantum"
                assert [d.id for d, _ in out[i]["documents"]] == [d.id for d, _ in want]
                np.testing.assert_allclose([s for _, s in out[i]["documents"]],
                                           [s for _, s in want], atol=1e-6)
        finally:
            batcher.close()


# -------------------------------------------------------------- profiling


def test_profiling_helpers(tmp_path):
    from qrag_tpu_torch.utils import profiling
    from qrag_tpu_torch.utils.metrics import GLOBAL_METRICS

    with profiling.trace(str(tmp_path / "t")) as log_dir:
        with profiling.annotate("qrag_stage"):
            (torch.ones(64) * 2).sum()
    path = os.path.join(log_dir, profiling.TRACE_NAME)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert "qrag_stage" in f.read()
    assert profiling.device_memory_stats() is None  # no card here
    before = GLOBAL_METRICS.snapshot()["latency"].get("torch_test_stage", {}).get("count", 0)
    with profiling.stage_timer("torch_test_stage"):
        pass
    assert GLOBAL_METRICS.snapshot()["latency"]["torch_test_stage"]["count"] == before + 1
