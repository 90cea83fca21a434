"""The port's trained models (``qrag_tpu_torch.models``) against the JAX
package's (``qrag_tpu.models``), on the CPU in f32: one set of weights
carried into both packages gives cross-encoder logits within rtol 1e-5,
atol 1e-4 (both heads, MoE and dense FFN) and bi-encoder embeddings
within atol 1e-5; the ``.npz`` flatten order is pinned against
``jax.tree_util.tree_flatten``; the shipped artifacts give the same
scores and rerank order in both packages; bf16 activations stay within
``BF16_SCORE_ATOL`` / ``BF16_COSINE_FLOOR`` of f32 (the tolerance
``chip_smoke.py`` holds the card to); and the classical reranker's
cross-encoder route, ``chunk_pool`` and the sticky fallback behave as
the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu import config as jconfig
from qrag_tpu.documents import Document as JDoc
from qrag_tpu.models import bi_encoder as jbe
from qrag_tpu.models import cross_encoder as jce
from qrag_tpu.pipeline import corpus_gen as jcorpus
from qrag_tpu.reranker.classical import ClassicalReranker as JClassical
from qrag_tpu_torch import config as tconfig
from qrag_tpu_torch.documents import Document as TDoc
from qrag_tpu_torch.models import bi_encoder as tbe
from qrag_tpu_torch.models import cross_encoder as tce
from qrag_tpu_torch.models import weights
from qrag_tpu_torch.pipeline.embeddings import get_embedder
from qrag_tpu_torch.reranker.classical import ClassicalReranker

# empty, non-ASCII and longer-than-pos_emb documents ride in every batch
DOCS = ["doc a about vaccines", "", "héllo wörld ✓ " * 6, "x" * 150, "sponsor deal " * 20]
QUERIES = ["what about the vaccine", "", "ünïcode ✓"]


def _jce_cfg(head, n_experts, max_len=48):
    return jce.CrossEncoderConfig(dim=32, n_heads=4, n_layers=2, max_len=max_len,
                                  n_experts=n_experts, head_type=head, dtype=jnp.float32)


def _tce_cfg(head, n_experts, max_len=48):
    return tce.CrossEncoderConfig(dim=32, n_heads=4, n_layers=2, max_len=max_len,
                                  n_experts=n_experts, head_type=head)


def _jbe_cfg(n_experts=2):
    return jbe.BiEncoderConfig(
        tower=jce.CrossEncoderConfig(dim=32, n_heads=4, n_layers=2, max_len=40,
                                     n_experts=n_experts, dtype=jnp.float32),
        out_dim=16,
    )


def _tbe_cfg(n_experts=2):
    return tbe.BiEncoderConfig(
        tower=tce.CrossEncoderConfig(dim=32, n_heads=4, n_layers=2, max_len=40,
                                     n_experts=n_experts),
        out_dim=16,
    )


def _jax_params(init, cfg, seed, jitter=0.3, pos_rows=None):
    """Random JAX parameters, every leaf moved off its init value (so
    the closed gates and zero biases exercise their paths), with
    ``pos_emb`` cut to ``pos_rows`` rows as in the shipped weights."""
    p = init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + jitter * rng.standard_normal(np.shape(a)).astype(np.float32), p
    )
    if pos_rows is not None:
        p["pos_emb"] = p["pos_emb"][:pos_rows]
    return p


def _tree_names(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in leaves
    ]


# -------------------------------------------------------------- flatten order


@pytest.mark.parametrize(
    "kind,head,n_experts",
    [("cross", "interaction", 4), ("cross", "cls", 4), ("cross", "cls", 0),
     ("cross", "interaction", 0), ("bi", "cls", 4), ("bi", "cls", 0)],
)
def test_flatten_order_pinned(kind, head, n_experts):
    """``param_paths`` rebuilds ``tree_flatten``'s order without jax,
    and the port's state-dict names are those paths."""
    if kind == "cross":
        jcfg, tcfg = _jce_cfg(head, n_experts), _tce_cfg(head, n_experts)
        params = jce.init_params(jax.random.PRNGKey(0), jcfg)
        module = tce.CrossEncoder(tcfg)
    else:
        jcfg, tcfg = _jbe_cfg(n_experts), _tbe_cfg(n_experts)
        params = jbe.init_params(jax.random.PRNGKey(0), jcfg)
        module = tbe.BiEncoder(tcfg)
    names = weights.param_paths(tcfg)
    assert names == _tree_names(params)
    assert sorted(names) == sorted(module.state_dict())
    flat = jax.tree_util.tree_leaves(params)
    for name, leaf in zip(names, flat):
        assert tuple(module.state_dict()[name].shape) == tuple(np.shape(leaf)), name


def test_shipped_npz_layout():
    """The shipped cross-encoder's p0..p37 in the documented order,
    with a 128-row pos_emb under a 224-token max_len."""
    cfg = tce._load_scorer_config("artifacts/cross_encoder")
    names = weights.param_paths(cfg)
    assert names[:6] == ["final_ln.b", "final_ln.g", "head.b", "head.w", "iproj.b", "iproj.w"]
    assert names[6:21] == [
        "layers.0.attn.out.b", "layers.0.attn.out.w", "layers.0.attn.qkv.b",
        "layers.0.attn.qkv.w", "layers.0.ln1.b", "layers.0.ln1.g", "layers.0.ln2.b",
        "layers.0.ln2.g", "layers.0.moe.b1", "layers.0.moe.b2", "layers.0.moe.router.b",
        "layers.0.moe.router.w", "layers.0.moe.w1", "layers.0.moe.w2", "layers.0.xgate",
    ]
    assert names[36:] == ["pos_emb", "tok_emb"]
    with np.load("artifacts/cross_encoder/params.npz") as data:
        flat = weights.params_from_npz(data, cfg)
    assert cfg.max_len == 224 and flat["pos_emb"].shape == (128, 128)
    bcfg = tbe._load_config("artifacts/bi_encoder")
    bnames = weights.param_paths(bcfg)
    assert bnames[-3:] == ["proj.b", "proj.w", "tok_emb"] and "head.w" not in bnames
    with np.load("artifacts/bi_encoder/bi_encoder.npz") as data:
        assert len(data.files) == len(bnames)


def test_params_from_jax_tree_rejects_other_geometry():
    params = jce.init_params(jax.random.PRNGKey(0), _jce_cfg("cls", 2))
    with pytest.raises(ValueError):
        weights.params_from_jax_tree(params, _tce_cfg("interaction", 2))


# ---------------------------------------------------------------- forwards


def test_tokenizers_equal():
    for q in QUERIES:
        for a, b in zip(jce.tokenize_batch(q, DOCS, 48), tce.tokenize_batch(q, DOCS, 48)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jbe.tokenize_texts(DOCS + QUERIES, 40), tbe.tokenize_texts(DOCS + QUERIES, 40)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("head,n_experts", [("interaction", 2), ("interaction", 0),
                                            ("cls", 2), ("cls", 0)])
def test_cross_encoder_logits_match_jax(head, n_experts):
    """Carried weights, both heads: logits within rtol 1e-5, atol 1e-4,
    including an empty query, an empty document, non-ASCII bytes and
    (interaction) documents past the 16 rows of pos_emb."""
    jcfg, tcfg = _jce_cfg(head, n_experts), _tce_cfg(head, n_experts)
    rows = 16 if head == "interaction" else None
    p = _jax_params(jce.init_params, jcfg, seed=3, pos_rows=rows)
    scorer = tce.CrossEncoderScorer(tcfg, params=weights.params_from_jax_tree(p, tcfg),
                                    device="cpu")
    for q in QUERIES:
        toks, mask = jce.tokenize_batch(q, DOCS, jcfg.max_len)
        want = np.asarray(jce.forward(p, jnp.asarray(toks), jnp.asarray(mask), jcfg))
        got = scorer.logits(toks, mask).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_cls_head_refuses_tokens_past_pos_emb():
    """The "cls" head slices pos_emb[:T]: past its rows JAX fails, and
    the port raises instead of clipping."""
    jcfg, tcfg = _jce_cfg("cls", 2), _tce_cfg("cls", 2)
    p = _jax_params(jce.init_params, jcfg, seed=4, pos_rows=16)
    toks, mask = jce.tokenize_batch("q", ["d" * 40], jcfg.max_len)
    with pytest.raises((TypeError, ValueError)):
        jce.forward(p, jnp.asarray(toks), jnp.asarray(mask), jcfg)
    scorer = tce.CrossEncoderScorer(tcfg, params=weights.params_from_jax_tree(p, tcfg),
                                    device="cpu")
    with pytest.raises(ValueError, match="pos_emb"):
        scorer.logits(toks, mask)


@pytest.mark.parametrize("n_experts", [2, 0])
def test_bi_encoder_embeddings_match_jax(n_experts):
    jcfg, tcfg = _jbe_cfg(n_experts), _tbe_cfg(n_experts)
    p = _jax_params(jbe.init_params, jcfg, seed=5)
    texts = DOCS + QUERIES
    want = jbe.TrainedEmbedder(jcfg, params=p)(texts)
    emb = tbe.TrainedEmbedder(tcfg, params=weights.params_from_jax_tree(p, tcfg),
                              device="cpu", batch_size=3)
    got = emb(texts)
    assert got.shape == (len(texts), 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert emb([]).shape == (0, 16)


def test_weights_cross_both_ways(tmp_path):
    """A scorer saved by one package loads in the other and scores the
    same (the flat npz + config.json are the shared format)."""
    jcfg, tcfg = _jce_cfg("interaction", 2), _tce_cfg("interaction", 2)
    j = jce.CrossEncoderScorer(jcfg, seed=7)
    j.save(str(tmp_path / "jax"))
    t = tce.CrossEncoderScorer(tcfg, seed=11, device="cpu")
    assert not np.allclose(t.score("q", DOCS), j.score("q", DOCS), atol=1e-4)
    t.load(str(tmp_path / "jax"))
    np.testing.assert_allclose(t.score("q", DOCS), j.score("q", DOCS), atol=1e-5)
    t2 = tce.CrossEncoderScorer(tcfg, seed=13, device="cpu")
    t2.save(str(tmp_path / "torch"))
    j.load(str(tmp_path / "torch"))
    np.testing.assert_allclose(j.score("q", DOCS), t2.score("q", DOCS), atol=1e-5)
    be = tbe.TrainedEmbedder(_tbe_cfg(), seed=3, device="cpu")
    be.save(str(tmp_path / "bi"))
    jb = jbe.TrainedEmbedder(_jbe_cfg(), weights_dir=str(tmp_path / "bi"))
    np.testing.assert_allclose(be(DOCS), jb(DOCS), atol=1e-5)


def test_random_init_from_seeded_generator():
    a = tce.CrossEncoderScorer(_tce_cfg("cls", 2), seed=1, device="cpu")
    b = tce.CrossEncoderScorer(_tce_cfg("cls", 2), seed=1, device="cpu")
    c = tce.CrossEncoderScorer(_tce_cfg("cls", 2), seed=2, device="cpu")
    s = a.score("q", DOCS)
    np.testing.assert_array_equal(s, b.score("q", DOCS))
    assert not np.allclose(s, c.score("q", DOCS))
    assert ((s > 0) & (s < 1)).all() and a.forward_calls == 1
    default = tce.CrossEncoderScorer(seed=0, device="cpu")  # the default geometry
    assert default.cfg.dim == 256 and default.cfg.head_type == "cls"
    assert default.score("query", ["doc"]).shape == (1,)


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tce.CrossEncoderScorer(_tce_cfg("cls", 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbe.TrainedEmbedder(_tbe_cfg())


# ------------------------------------------------------- shipped artifacts


@pytest.fixture(scope="module")
def fixture_pairs():
    chunks = jcorpus.generate_corpus(8, 8, seed=0)
    rng = np.random.RandomState(0)
    queries = [jcorpus.make_query(chunks[i], rng) for i in (0, 9, 27)]
    return queries, [c.text for c in chunks[:32]] + ["", "é✓ " * 120]


def test_shipped_cross_encoder_scores_match(fixture_pairs):
    queries, docs = fixture_pairs
    jcc = jconfig.ClassicalConfig(model_cache_dir="artifacts", model_name="cross_encoder")
    tcc = tconfig.ClassicalConfig(model_cache_dir="artifacts", model_name="cross_encoder")
    js = jce.CrossEncoderScorer.from_config(jcc)
    ts = tce.CrossEncoderScorer.from_config(tcc, device="cpu")
    assert ts.cfg.head_type == "interaction" and ts.model.pos_emb.shape == (128, 128)
    for q in queries + [""]:
        want, got = js.score(q, docs), ts.score(q, docs)
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_array_equal(np.argsort(-got, kind="stable")[:10],
                                      np.argsort(-want, kind="stable")[:10])


def test_shipped_bi_encoder_matches(fixture_pairs):
    queries, docs = fixture_pairs
    want = jbe.TrainedEmbedder(weights_dir="artifacts/bi_encoder")(queries + docs)
    got = tbe.TrainedEmbedder(weights_dir="artifacts/bi_encoder", device="cpu")(queries + docs)
    assert got.shape == (len(queries) + len(docs), 128)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bf16_tolerance_on_shipped_weights():
    """bf16 activations against f32, the same shipped weights, on 100
    corpus pairs and 200 texts: every sigmoid score within
    BF16_SCORE_ATOL (0.03) and every embedding's cosine to its f32 twin
    at or above BF16_COSINE_FLOOR (0.999).  chip_smoke.py holds the
    card to these numbers."""
    assert tce.BF16_SCORE_ATOL == 0.03 and tbe.BF16_COSINE_FLOOR == 0.999
    chunks = jcorpus.generate_corpus(16, 8, seed=0)
    rng = np.random.RandomState(1)
    query = jcorpus.make_query(chunks[5], rng)
    docs = [chunks[int(i)].text for i in rng.randint(len(chunks), size=100)]
    tcc = tconfig.ClassicalConfig(model_cache_dir="artifacts", model_name="cross_encoder")
    f32 = tce.CrossEncoderScorer.from_config(tcc, device="cpu")
    bf16 = tce.CrossEncoderScorer.from_config(tcc, device="cpu", dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    diff = np.abs(bf16.score(query, docs) - f32.score(query, docs))
    assert diff.max() <= tce.BF16_SCORE_ATOL, diff.max()
    texts = [c.text for c in chunks[:100]] + [jcorpus.make_query(c, rng) for c in chunks[:98]]
    texts += ["", "é✓" * 80]
    ef = tbe.TrainedEmbedder(weights_dir="artifacts/bi_encoder", device="cpu")(texts)
    eb = tbe.TrainedEmbedder(weights_dir="artifacts/bi_encoder", device="cpu",
                             dtype=torch.bfloat16)(texts)
    assert eb.dtype == np.float32
    assert (ef * eb).sum(1).min() >= tbe.BF16_COSINE_FLOOR


def test_get_embedder_trained_provider():
    e = get_embedder(tconfig.EmbeddingConfig(provider="trained", dim=64, model="none"),
                     device="cpu")
    out = e(["abc", ""])
    assert out.shape == (2, 64) and np.allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    shipped = get_embedder(
        tconfig.EmbeddingConfig(provider="trained", dim=1536, model="artifacts/bi_encoder"),
        device="cpu",
    )
    assert shipped.dim == 128  # the weights' config.json wins over config.dim
    want = jbe.TrainedEmbedder(weights_dir="artifacts/bi_encoder")(["a query"])
    np.testing.assert_allclose(shipped(["a query"]), want, atol=1e-5)


# ------------------------------------------------------- classical reranker


def _rerankers(**over):
    kw = dict(method="cross-encoder", model_cache_dir="artifacts",
              model_name="cross_encoder", **over)
    return (JClassical(jconfig.ClassicalConfig(**kw)),
            ClassicalReranker(tconfig.ClassicalConfig(**kw), device="cpu"))


def test_classical_cross_encoder_route_matches_jax(fixture_pairs):
    queries, docs = fixture_pairs
    jr, tr = _rerankers()
    jdocs = [JDoc(str(i), d) for i, d in enumerate(docs[:20])]
    tdocs = [TDoc(str(i), d) for i, d in enumerate(docs[:20])]
    for q in queries:
        want = jr.rerank(q, jdocs, top_k=10)
        got = tr.rerank(q, tdocs, top_k=10)
        assert [d.id for d, _ in got] == [d.id for d, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5)
    assert tr._active_method == "cross-encoder"
    assert tr._cross_encoder.forward_calls == len(queries)  # 20 docs: one batch each


def test_chunk_pool_matches_jax():
    """chunk_pool scores windows of each long document and keeps the
    best: the same windows and scores as the reference."""
    long_doc = "padding words " * 60 + " vaccine inoculation clinic " + "tail " * 40
    docs = [long_doc, "a short irrelevant text", "clinic vaccine"]
    jr, tr = _rerankers(long_doc_strategy="chunk_pool", enable_cache=False)
    q = "inoculation clinic"
    want = jr.rerank(q, [JDoc(str(i), d) for i, d in enumerate(docs)])
    got = tr.rerank(q, [TDoc(str(i), d) for i, d in enumerate(docs)])
    assert [d.id for d, _ in got] == [d.id for d, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5)
    # the long document was cut into windows and scored in one batch
    assert tr._cross_encoder.forward_calls == 1


def test_chunk_pool_sees_buried_passage():
    class Spy:
        cfg = tce.CrossEncoderConfig(max_len=224)

        def __init__(self):
            self.calls = []

        def score(self, query, pieces):
            self.calls.append(list(pieces))
            return np.asarray([1.0 if "XMARKERX" in p else 0.0 for p in pieces], np.float32)

    docs = [TDoc("buried", "padding words " * 400 + " XMARKERX"), TDoc("plain", "short")]
    rr = ClassicalReranker(
        tconfig.ClassicalConfig(method="cross-encoder", long_doc_strategy="chunk_pool",
                                enable_cache=False), device="cpu")
    rr._cross_encoder = spy = Spy()
    out = rr.rerank("q", docs)
    assert out[0][0].id == "buried" and out[0][1] == 1.0
    assert len(spy.calls[0]) > 2


class _Failing:
    """A cross-encoder that fails from its ``fail_from``-th call on."""

    cfg = tce.CrossEncoderConfig(max_len=224)

    def __init__(self, fail_from=0):
        self.calls = 0
        self.fail_from = fail_from

    def score(self, query, pieces):
        self.calls += 1
        if self.calls > self.fail_from:
            raise RuntimeError("device fault")
        return np.full(len(pieces), 0.9, np.float32)


@pytest.mark.parametrize("fail_from", [0, 1])
def test_sticky_fallback_to_cosine_matches_jax(fail_from):
    """A scorer that fails out (from the first batch, or from the second
    batch of a 40-document request): the request is rescored whole on
    cosine, the cache cleared, and later requests skip the
    cross-encoder — as in the reference."""
    texts = [f"document {i} about topic {i % 3}" for i in range(40)]
    jr, tr = _rerankers(max_retries=1)
    jr._cross_encoder, tr._cross_encoder = _Failing(fail_from), _Failing(fail_from)
    want = jr.rerank("topic 1", [JDoc(str(i), t) for i, t in enumerate(texts)])
    got = tr.rerank("topic 1", [TDoc(str(i), t) for i, t in enumerate(texts)])
    assert tr._active_method == jr._active_method == "cosine"
    assert [d.id for d, _ in got] == [d.id for d, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)
    assert all(s < 0.9 for _, s in got)  # no cross-encoder score survived
    calls = tr._cross_encoder.calls
    tr.rerank("topic 2", [TDoc("a", "topic 2 text")])
    assert tr._cross_encoder.calls == calls  # sticky
