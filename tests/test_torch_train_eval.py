"""The port's training harnesses (``qrag_tpu_torch.models.rerank_eval``,
``recall_eval``, ``distill``) against the JAX package's, on the CPU in
f32 at small sizes.

Both packages load one bi-encoder artifact (random JAX weights saved by
the JAX package).  The warm start is the same dict bit for bit; the
listwise fine-tune (with and without the fidelity-distill term) gives
JAX's loss trace within rtol 1e-4; the evaluation cases and metrics are
JAX's exactly; ``train_bi_encoder`` from carried JAX initial parameters
gives JAX's loss trace and the same recall@k; ``distill`` warm-started
with the artifact as teacher gives JAX's trace, Spearman and top-1
agreement; and both ``run_eval``s report the same numbers.  Two outputs
draw random weights and so are the port's own (``torch.Generator``, not
jax.random): ``run_eval``'s "cross_encoder_untrained" floor and
distill's default random teacher.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qrag_tpu.models import bi_encoder as jbe
from qrag_tpu.models import cross_encoder as jce
from qrag_tpu.models import distill as jdistill
from qrag_tpu.models import recall_eval as jrecall
from qrag_tpu.models import rerank_eval as jrerank
from qrag_tpu.pipeline import corpus_gen as jcorpus
from qrag_tpu.pipeline.embeddings import HashEmbedder as JHash
from qrag_tpu_torch.models import bi_encoder as tbe
from qrag_tpu_torch.models import distill as tdistill
from qrag_tpu_torch.models import recall_eval as trecall
from qrag_tpu_torch.models import rerank_eval as trerank
from qrag_tpu_torch.models import weights
from qrag_tpu_torch.pipeline import corpus_gen as tcorpus
from qrag_tpu_torch.pipeline.embeddings import HashEmbedder as THash


@pytest.fixture(scope="module")
def bi_artifact(tmp_path_factory):
    """A random JAX bi-encoder saved as an artifact: the shipped one's
    layout at tiny width."""
    cfg = jbe.BiEncoderConfig(
        tower=jce.CrossEncoderConfig(dim=32, n_heads=2, n_layers=2, max_len=128, n_experts=2,
                                     dtype=jnp.float32),
        out_dim=32,
    )
    emb = jbe.TrainedEmbedder(cfg, params=jbe.init_params(jax.random.PRNGKey(3), cfg))
    d = tmp_path_factory.mktemp("bi_art")
    emb.save(str(d))
    return str(d)


def _rerank_cfgs(weights_dir, **over):
    kw = dict(n_episodes=8, chunks_per_episode=4, steps=2, batch=4, init_from=weights_dir,
              dim=32, heads=2, n_experts=2, **{"max_len": 128, **over})
    return jrerank.RerankEvalConfig(**kw), trerank.RerankEvalConfig(**kw)


def _assert_trace(got, want, rtol=1e-4):
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=rtol)


def test_warm_start_params_match_jax(bi_artifact):
    jcfg, tcfg = _rerank_cfgs(bi_artifact)
    want = jrerank.warm_start_params(jrerank._make_cfg(jcfg), bi_artifact)
    want = weights.params_from_jax_tree(jax.tree_util.tree_map(np.asarray, want),
                                        trerank._make_cfg(tcfg))
    got = trerank.warm_start_params(trerank._make_cfg(tcfg), bi_artifact)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float32 and np.array_equal(got[name], want[name]), name
    with pytest.raises(ValueError, match="tower mismatch"):
        trerank.warm_start_params(trerank._make_cfg(trerank.RerankEvalConfig(dim=64)),
                                  bi_artifact)


@pytest.mark.parametrize("distill_weight", [0.0, 1.0])
def test_train_cross_encoder_trace_matches_jax(bi_artifact, distill_weight):
    """The listwise fine-tune of ``tests/test_rerank_quality.py``'s size
    (two steps, Q = 4), warm-started from the shared artifact: JAX's
    loss trace within rtol 1e-4, the curve hook at the same steps, and
    the fine-tuned scorers agree."""
    jcfg, tcfg = _rerank_cfgs(bi_artifact, distill_weight=distill_weight, curve_every=2,
                              max_len=96)
    chunks = jcorpus.generate_corpus(8, 4, seed=0)
    train_idx, _ = jcorpus.split_by_episode(chunks, 0.25, seed=1)
    jseen, tseen = [], []
    js, jl = jrerank.train_cross_encoder(jcfg, chunks, train_idx,
                                         hook=lambda at, sc: jseen.append(at))
    tchunks = tcorpus.generate_corpus(8, 4, seed=0)
    ts, tl = trerank.train_cross_encoder(tcfg, tchunks, train_idx, device="cpu",
                                         hook=lambda at, sc: tseen.append(sc))
    _assert_trace(tl, jl)
    assert jseen == [2] and len(tseen) == 1
    docs = [c.text for c in chunks[:6]]
    np.testing.assert_allclose(ts.score("find prices", docs), js.score("find prices", docs),
                               atol=1e-4)
    np.testing.assert_array_equal(tseen[0].score("q", docs), ts.score("q", docs))
    assert all(np.isfinite(float(ts.model.get_parameter(f"layers.{i}.xgate")))
               for i in range(2))


def test_distill_aux_requires_warm_start():
    chunks = tcorpus.generate_corpus(8, 4, seed=0)
    train_idx, _ = tcorpus.split_by_episode(chunks, 0.25, seed=1)
    _, cfg = _rerank_cfgs(None, distill_weight=0.5)
    with pytest.raises(ValueError, match="distill_weight"):
        trerank.train_cross_encoder(cfg, chunks, train_idx, device="cpu")


def test_eval_cases_and_ranker_match_jax(bi_artifact):
    jcfg, tcfg = _rerank_cfgs(bi_artifact, candidates=16)
    jchunks, tchunks = jcorpus.generate_corpus(8, 4, seed=0), tcorpus.generate_corpus(8, 4, seed=0)
    _, hold_idx = jcorpus.split_by_episode(jchunks, 0.25, seed=1)
    for seed in (17, 29):
        want = jrerank._eval_cases(jcfg, jchunks, hold_idx, seed=seed)
        got = trerank._eval_cases(tcfg, tchunks, hold_idx, seed=seed)
        assert [(q, [int(c) for c in cand], p) for q, cand, p in got] == [
            (q, [int(c) for c in cand], p) for q, cand, p in want]
    jcos, tcos = jrerank._cosine_scorer(JHash(256)), trerank._cosine_scorer(THash(256), "cpu")
    docs = [c.text for c in tchunks[:9]]
    np.testing.assert_allclose(tcos("a query", docs), jcos("a query", docs), atol=1e-6)
    assert trerank.eval_ranker(tcos, tchunks, got) == jrerank.eval_ranker(jcos, jchunks, want)
    tbi = trerank._cosine_scorer(tbe.TrainedEmbedder(weights_dir=bi_artifact, device="cpu"), "cpu")
    jbi = jrerank._cosine_scorer(jbe.TrainedEmbedder(weights_dir=bi_artifact))
    assert trerank.eval_ranker(tbi, tchunks, got) == jrerank.eval_ranker(jbi, jchunks, want)


def test_rerank_run_eval_matches_jax(bi_artifact):
    """The whole harness at a tiny size: every number the reference
    reports but the port's own random floor and the timing."""
    jcfg, tcfg = _rerank_cfgs(bi_artifact, candidates=8, extra_train_episodes=2, max_len=96,
                              queries_per_chunk=1)
    want = jrerank.run_eval(jcfg)
    got = trerank.run_eval(tcfg, device="cpu")
    assert set(got) == set(want)
    _assert_trace(got.pop("loss_trace"), want.pop("loss_trace"))
    for key in ("train_seconds", "cross_encoder_untrained"):
        got.pop(key), want.pop(key)
    assert got == want


def test_resolve_init_from(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    assert trerank.resolve_init_from("artifacts/bi_encoder") == os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "artifacts", "bi_encoder"))
    assert trerank.resolve_init_from(None) is None
    with caplog.at_level(logging.WARNING):
        assert trerank.resolve_init_from("no/such/dir") is None
    assert "FROM SCRATCH" in caplog.text


def _carried_bi_init(monkeypatch):
    """``bi_encoder.init_params`` replaced by JAX's initial parameters."""

    def init(cfg, seed):
        t = cfg.tower
        jcfg = jbe.BiEncoderConfig(
            tower=jce.CrossEncoderConfig(dim=t.dim, n_heads=t.n_heads, n_layers=t.n_layers,
                                         max_len=t.max_len, n_experts=t.n_experts,
                                         dtype=jnp.float32),
            out_dim=cfg.out_dim,
        )
        p = jbe.init_params(jax.random.PRNGKey(seed), jcfg)
        return weights.params_from_jax_tree(jax.tree_util.tree_map(np.asarray, p), cfg)

    monkeypatch.setattr(tbe, "init_params", init)


def test_recall_eval_matches_jax(monkeypatch):
    """``run_eval`` from the same initial parameters: JAX's loss trace
    within rtol 1e-4 and the same recall@k, trained and hash."""
    _carried_bi_init(monkeypatch)
    kw = dict(n_episodes=8, chunks_per_episode=4, steps=3, batch=8, dim=32, layers=1, heads=2,
              out_dim=32, max_len=64)
    want = jrecall.run_eval(jrecall.RecallEvalConfig(**kw))
    got = trecall.run_eval(trecall.RecallEvalConfig(**kw), device="cpu")
    _assert_trace(got.pop("loss_trace"), want.pop("loss_trace"))
    got.pop("train_seconds"), want.pop("train_seconds")
    assert got == want


def test_distill_matches_jax(bi_artifact):
    """Student warm-started from the artifact, the artifact as teacher:
    JAX's loss trace, Spearman and top-1 agreement."""
    kw = dict(n_episodes=8, chunks_per_episode=3, docs_per_query=6, n_queries=16, steps=3,
              batch=8, dim=32, heads=2, layers=2, n_experts=2, max_len=96,
              init_from=bi_artifact, teacher_weights=bi_artifact)
    want, jparams, _ = jdistill.distill(jdistill.DistillConfig(**kw))
    got, tparams, ce_cfg = tdistill.distill(tdistill.DistillConfig(**kw), device="cpu")
    assert ce_cfg.head_type == "interaction" and ce_cfg.n_experts == 2
    _assert_trace(got.pop("loss_trace"), want.pop("loss_trace"))
    assert got == want
    assert sorted(tparams) == sorted(weights.params_from_jax_tree(
        jax.tree_util.tree_map(np.asarray, jparams), ce_cfg))


def test_teacher_fidelity_matches_jax(bi_artifact):
    qs = ["what did they say about vote", "find the segment on prices"]
    docs = [["doc one text", "doc two text", ""], ["doc three", "doc four", "é✓"]]
    want = jdistill.teacher_fidelity(qs, docs, 10,
                                     embedder=jbe.TrainedEmbedder(weights_dir=bi_artifact))
    emb = tdistill.default_teacher_embedder(10, bi_artifact, device="cpu")
    got = tdistill.teacher_fidelity(qs, docs, 10, embedder=emb)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the default random teacher is the port's own: bounded and fixed
    rand = tdistill.default_teacher_embedder(10, device="cpu")
    f1 = tdistill.teacher_fidelity(qs, docs, 10, embedder=rand)
    np.testing.assert_array_equal(f1, tdistill.teacher_fidelity(qs, docs, 10, embedder=rand))
    assert f1.shape == (6,) and ((f1 >= 0) & (f1 <= 1 + 1e-6)).all()
    assert tdistill._spearman(np.arange(4.0), np.arange(4.0)) == pytest.approx(1.0)
