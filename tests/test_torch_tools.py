"""The port's tool layer (``qrag_tpu_torch.tools``, no pydantic): the
cases of the reference's ``tests/test_tools.py`` run against it, the
tool schemas and input coercions against pydantic's, index files
crossing between the packages both ways, the ``corpus_gen`` and
``storage`` copies against the reference's, and the trained-embedding
ingestion -> search slice against the JAX package's on the CPU.
"""

import asyncio
import json

import numpy as np
import pytest

from qrag_tpu.config import EmbeddingConfig as JEmbeddingConfig
from qrag_tpu.index import faiss_io as jfaiss
from qrag_tpu.pipeline import corpus_gen as jcorpus
from qrag_tpu.pipeline.storage import LocalTranscriptStore as JStore
from qrag_tpu.tools import ToolService as JToolService
from qrag_tpu.tools import default_tools as j_default_tools
from qrag_tpu.tools import ingest_tools as jtools
from qrag_tpu_torch.config import EmbeddingConfig
from qrag_tpu_torch.index import faiss_io
from qrag_tpu_torch.pipeline import corpus_gen
from qrag_tpu_torch.pipeline.storage import LocalTranscriptStore, get_store
from qrag_tpu_torch.tools import (
    FetchEmbeddingsTool,
    ToolService,
    default_tools,
)
from qrag_tpu_torch.tools import ingest_tools as ttools
from qrag_tpu_torch.tools.ingest_tools import extract_texts
from qrag_tpu_torch.tools.interface import Model, ToolResponse, ValidationError


def tool_run(tool, args):
    return asyncio.run(tool.execute(tool.input_model(**args)))


def _write_transcripts(root, shows):
    for show, episodes in shows.items():
        d = root / show / "2024"
        d.mkdir(parents=True)
        for ep, data in episodes.items():
            (d / f"{ep}_transcript.json").write_text(json.dumps(data))
    return str(root)


@pytest.fixture()
def transcripts_dir(tmp_path):
    """A local store shaped like the reference's S3 layout:
    <show>/<subdir>/<episode>_transcript.json (>=3 path segments)."""
    return _write_transcripts(tmp_path / "transcripts", {
        "Piers_Morgan_Uncensored": {
            ep: {"text": f"content of Piers_Morgan_Uncensored {ep} " * 20} for ep in ("ep1", "ep2")
        },
        "Other_Show": {"a": {"text": "content of Other_Show a " * 20}},
    })


@pytest.fixture()
def service(transcripts_dir):
    svc = ToolService()
    svc.register_tools(default_tools(
        store=LocalTranscriptStore(transcripts_dir),
        config=EmbeddingConfig(provider="hash", dim=64),
        device="cpu",
    ))
    return svc


# ------------------------------------------------------------------ registry


def test_registry_and_schemas(service):
    names = [t.name for t in service.tools]
    assert names == ["FetchEmbeddings", "ReadFromS3", "StoreInFaiss",
                     "ProcessTranscriptsToEmbeddings", "SearchIndex"]
    schema = service.tools[0].get_schema()
    assert schema["name"] == "FetchEmbeddings"
    assert "texts" in schema["input"]["properties"]


def test_schemas_equal_pydantic(tmp_path):
    """``Tool.get_schema`` of every tool equals the reference's (the
    reference's come from pydantic), as JSON text."""
    jsvc = JToolService()
    jsvc.register_tools(j_default_tools(config=JEmbeddingConfig(provider="hash", dim=8)))
    tsvc = ToolService()
    tsvc.register_tools(default_tools(config=EmbeddingConfig(provider="hash", dim=8),
                                      device="cpu"))
    assert json.dumps(tsvc.list_schemas()) == json.dumps(jsvc.list_schemas())


_COERCE_CASES = [
    ("SearchIndexInput", {"index_path": "p", "k": "5"}),
    ("SearchIndexInput", {"index_path": "p", "k": " 5 "}),
    ("SearchIndexInput", {"index_path": "p", "k": 5.0}),
    ("SearchIndexInput", {"index_path": "p", "k": 5.5}),
    ("SearchIndexInput", {"index_path": "p", "k": True}),
    ("SearchIndexInput", {"index_path": "p", "k": float("inf")}),
    ("SearchIndexInput", {"index_path": "p", "k": "five"}),
    ("SearchIndexInput", {"index_path": "p", "rerank": "true"}),
    ("SearchIndexInput", {"index_path": "p", "rerank": "off"}),
    ("SearchIndexInput", {"index_path": "p", "rerank": 1}),
    ("SearchIndexInput", {"index_path": "p", "rerank": 0.0}),
    ("SearchIndexInput", {"index_path": "p", "rerank": 2}),
    ("SearchIndexInput", {"index_path": "p", "rerank": "maybe"}),
    ("SearchIndexInput", {"index_path": 3}),
    ("SearchIndexInput", {"index_path": "p", "embedding": [1, 2]}),
    ("SearchIndexInput", {"index_path": "p", "embedding": ["1.5", 2]}),
    ("SearchIndexInput", {"index_path": "p", "embedding": (1, 2)}),
    ("SearchIndexInput", {"index_path": "p", "embedding": [True]}),
    ("SearchIndexInput", {"index_path": "p", "embedding": "ab"}),
    ("SearchIndexInput", {"index_path": "p", "query": None}),
    ("SearchIndexInput", {}),
    ("SearchIndexInput", {"index_path": "p", "bogus": 1}),
    ("FetchEmbeddingsInput", {"texts": "abc"}),
    ("FetchEmbeddingsInput", {"texts": ["a", 1]}),
    ("FetchEmbeddingsInput", {"texts": None}),
    ("FetchEmbeddingsInput", {"texts": ["a"], "model": None}),
    ("ProcessTranscriptsInput", {"show_name": "s", "index_path": "p", "max_transcripts": "2"}),
    ("ReadFromS3Input", {}),
    ("StoreInFaissInput", {"embeddings": [[1, 2.5]], "index_path": "p", "metadata": ["m"]}),
    ("StoreInFaissInput", {"embeddings": [[1, "x"]], "index_path": "p"}),
]


@pytest.mark.parametrize("model,args", _COERCE_CASES)
def test_input_coercion_matches_pydantic(model, args):
    """What pydantic's lax mode accepts the port accepts, with the same
    values; what it refuses the port refuses."""
    from pydantic import ValidationError as PydanticError

    try:
        want = getattr(jtools, model)(**args).model_dump()
    except PydanticError:
        with pytest.raises(ValidationError):
            getattr(ttools, model)(**args)
        return
    got = getattr(ttools, model)(**args).model_dump()
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_unknown_tool_error(service):
    resp = service.execute_tool_sync("Nope", {})
    assert not resp.success and "unknown tool" in resp.error
    assert resp.first_json()["available_tools"][0] == "FetchEmbeddings"


def test_input_validation_extra_field_rejected(service):
    resp = service.execute_tool_sync("FetchEmbeddings", {"texts": ["x"], "bogus": 1})
    assert not resp.success and "invalid input" in resp.error


def test_duplicate_registration_rejected(service):
    with pytest.raises(ValueError):
        service.register_tool(FetchEmbeddingsTool(config=EmbeddingConfig(provider="hash"),
                                                  device="cpu"))


# --------------------------------------------------------------------- tools


def test_fetch_embeddings_matches_reference(service):
    texts = ["hello", "world", ("sentence one. " * 5000)]  # the last one chunks
    resp = service.execute_tool_sync("FetchEmbeddings", {"texts": texts})
    assert resp.success
    out = resp.first_json()
    assert out["count"] == 3 and out["dimension"] == 64
    want = asyncio.run(jtools.FetchEmbeddingsTool(
        config=JEmbeddingConfig(provider="hash", dim=64)).execute(
            jtools.FetchEmbeddingsInput(texts=texts))).first_json()
    assert out == want


def test_fetch_embeddings_groups_cross_boundary(monkeypatch):
    """Texts split over several embedder calls give the vectors of one
    call per chunk, as in the reference."""
    monkeypatch.setattr(ttools, "EMBED_GROUP", 4)
    calls = []

    class Counting:
        dim = 8

        def __call__(self, texts):
            calls.append(len(texts))
            return ttools.get_embedder(EmbeddingConfig(provider="hash", dim=8))(texts)

    texts = [f"text {i}" for i in range(10)]
    out = tool_run(FetchEmbeddingsTool(embedder=Counting()), {"texts": texts}).first_json()
    assert calls == [4, 4, 2]
    want = asyncio.run(jtools.FetchEmbeddingsTool(
        config=JEmbeddingConfig(provider="hash", dim=8)).execute(
            jtools.FetchEmbeddingsInput(texts=texts))).first_json()
    assert out["embeddings"] == want["embeddings"]


def test_read_lists_shows(service):
    out = service.execute_tool_sync("ReadFromS3", {}).first_json()
    assert out["available_shows"] == ["Other_Show", "Piers_Morgan_Uncensored"]
    assert out["count"] == 0


def test_read_show_transcripts(service):
    out = service.execute_tool_sync(
        "ReadFromS3", {"show_name": "Piers_Morgan_Uncensored"}).first_json()
    assert out["count"] == 2
    t = out["transcripts"][0]
    assert set(t) == {"show_name", "episode_id", "file_path", "data"}
    assert t["episode_id"].startswith("ep")


def test_read_unknown_show_error_with_available(service):
    resp = service.execute_tool_sync("ReadFromS3", {"show_name": "nope"})
    assert not resp.success and "available_shows" in (resp.first_json() or {})


def test_store_in_faiss_append(tmp_path, service, rng):
    path = str(tmp_path / "t.faiss")
    embs = rng.randn(3, 16).astype(np.float32).tolist()
    r1 = service.execute_tool_sync(
        "StoreInFaiss", {"embeddings": embs, "index_path": path, "metadata": ["a", "b", "c"]})
    assert r1.success and r1.first_json()["total_vectors"] == 3
    r2 = service.execute_tool_sync("StoreInFaiss", {"embeddings": embs[:1], "index_path": path})
    assert r2.first_json()["total_vectors"] == 4
    assert faiss_io.read_metadata(path) == ["a", "b", "c"]


def test_store_dimension_mismatch_error(tmp_path, service, rng):
    path = str(tmp_path / "t.faiss")
    service.execute_tool_sync("StoreInFaiss",
                              {"embeddings": rng.randn(2, 8).tolist(), "index_path": path})
    resp = service.execute_tool_sync("StoreInFaiss",
                                     {"embeddings": rng.randn(2, 16).tolist(), "index_path": path})
    assert not resp.success and "dimension mismatch" in resp.error


def test_metadata_length_mismatch_error(tmp_path, service, rng):
    resp = service.execute_tool_sync("StoreInFaiss", {
        "embeddings": rng.randn(2, 8).tolist(), "index_path": str(tmp_path / "x.faiss"),
        "metadata": ["only-one"]})
    assert not resp.success


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_index_files_cross_packages(tmp_path, rng, writer):
    """A .faiss file and sidecar written by one package's StoreInFaiss
    are read by the other's faiss_io, bit for bit."""
    path = str(tmp_path / "x.faiss")
    embs = rng.randn(5, 12).astype(np.float32)
    args = {"embeddings": embs.tolist(), "index_path": path, "metadata": list("abcde")}
    tool = ttools.StoreInFaissTool() if writer == "torch" else jtools.StoreInFaissTool()
    assert tool_run(tool, args).success
    reader_io = jfaiss if writer == "torch" else faiss_io
    data = reader_io.read_flat_index(path)
    assert data.ntotal == 5 and data.d == 12 and data.metric == "l2"
    np.testing.assert_array_equal(np.asarray(data.vectors), embs)
    assert reader_io.read_metadata(path) == list("abcde")


# ------------------------------------------------------------------ pipeline


def test_process_pipeline_end_to_end(tmp_path, service):
    path = str(tmp_path / "pipe.faiss")
    resp = service.execute_tool_sync(
        "ProcessTranscriptsToEmbeddings",
        {"show_name": "Piers_Morgan_Uncensored", "index_path": path})
    assert resp.success, resp.error
    out = resp.first_json()
    assert (out["transcripts_processed"], out["embeddings_created"], out["total_vectors"]) == (2, 2, 2)
    data = faiss_io.read_flat_index(path)
    assert data.ntotal == 2 and data.metric == "l2"
    assert faiss_io.read_metadata(path)[0].startswith("Piers_Morgan_Uncensored/ep")


def test_process_case_insensitive_retry(tmp_path, service):
    resp = service.execute_tool_sync("ProcessTranscriptsToEmbeddings", {
        "show_name": "piers_morgan_uncensored", "index_path": str(tmp_path / "c.faiss")})
    assert resp.success
    assert resp.first_json()["show_name"] == "Piers_Morgan_Uncensored"


def test_process_unknown_show(tmp_path, service):
    resp = service.execute_tool_sync("ProcessTranscriptsToEmbeddings", {
        "show_name": "does-not-exist", "index_path": str(tmp_path / "n.faiss")})
    assert not resp.success and "available_shows" in (resp.first_json() or {})


def test_process_max_transcripts(tmp_path, service):
    resp = service.execute_tool_sync("ProcessTranscriptsToEmbeddings", {
        "show_name": "Piers_Morgan_Uncensored", "index_path": str(tmp_path / "m.faiss"),
        "max_transcripts": 1})
    assert resp.first_json()["transcripts_processed"] == 1


def test_extract_texts_payload_shapes():
    ts = [{"data": "plain string"}, {"data": {"text": "from text key"}},
          {"data": {"transcript": "from transcript key"}}, {"data": {"content": "from content key"}},
          {"data": ["list", "of", "strings"]}, {"data": {"unrelated": 1}}, {"data": 42}]
    texts, sources = extract_texts(ts)
    assert (texts, sources) == jtools.extract_texts(ts)
    assert sources == [0, 1, 2, 3, 4]


def test_pipeline_metadata_alignment_with_skips(tmp_path):
    class FakeStore:
        def list_shows(self):
            return ["S"]

        def read_show(self, show):
            return [
                {"show_name": "S", "episode_id": "bad", "file_path": "x", "data": 42},
                {"show_name": "S", "episode_id": "good1", "file_path": "y", "data": "text one"},
                {"show_name": "S", "episode_id": "good2", "file_path": "z",
                 "data": {"text": "text two"}},
            ]

    tool = ttools.ProcessTranscriptsToEmbeddingsTool(
        store=FakeStore(), config=EmbeddingConfig(provider="hash", dim=16), device="cpu")
    path = str(tmp_path / "a.faiss")
    resp = tool_run(tool, {"show_name": "S", "index_path": path})
    assert resp.success, resp.error
    assert faiss_io.read_metadata(path) == ["S/good1", "S/good2"]


def test_search_index_tool(tmp_path, service):
    path = str(tmp_path / "s.faiss")
    assert service.execute_tool_sync("ProcessTranscriptsToEmbeddings", {
        "show_name": "Piers_Morgan_Uncensored", "index_path": path}).success
    out = service.execute_tool_sync("SearchIndex", {
        "index_path": path, "query": "content of Piers_Morgan_Uncensored ep2 " * 20, "k": 2})
    assert out.success, out.error
    payload = out.first_json()
    assert payload["count"] == 2
    assert payload["hits"][0]["metadata"].startswith("Piers_Morgan_Uncensored/ep2")
    out2 = service.execute_tool_sync(
        "SearchIndex", {"index_path": path, "query": "anything", "k": 1, "rerank": True})
    assert out2.success and out2.first_json()["reranked"]


def test_search_index_tool_errors(tmp_path, service):
    out = service.execute_tool_sync(
        "SearchIndex", {"index_path": str(tmp_path / "none.faiss"), "query": "x"})
    assert not out.success and "not found" in out.error
    path = str(tmp_path / "d.faiss")
    service.execute_tool_sync("ProcessTranscriptsToEmbeddings",
                              {"show_name": "Other_Show", "index_path": path})
    out = service.execute_tool_sync("SearchIndex", {"index_path": path, "embedding": [0.1, 0.2]})
    assert not out.success and "dim" in out.error
    out = service.execute_tool_sync("SearchIndex", {"index_path": path})
    assert not out.success and "query or embedding" in out.error


def test_fetch_embeddings_skip_on_error_reports_indices():
    class FlakyEmbedder:
        dim = 8

        def __call__(self, texts):
            if any("poison" in t for t in texts):
                raise RuntimeError("embed failure")
            return np.ones((len(texts), 8), np.float32)

    resp = tool_run(FetchEmbeddingsTool(embedder=FlakyEmbedder()),
                    {"texts": ["ok one", "poison text", "ok two"]})
    assert resp.success
    out = resp.first_json()
    assert out["count"] == 2 and out["skipped_indices"] == [1]
    allbad = tool_run(FetchEmbeddingsTool(embedder=FlakyEmbedder()), {"texts": ["poison"]})
    assert not allbad.success and "all embeddings failed" in allbad.error


def test_openai_embedder_gated_error():
    from qrag_tpu_torch.pipeline.embeddings import OpenAIEmbedder

    with pytest.raises(RuntimeError, match="openai|API key"):
        OpenAIEmbedder()(["text"])


def test_tool_response_helpers():
    class Out(Model):
        a: int

    r = ToolResponse.from_model(Out(a=3))
    assert r.success and r.first_json() == {"a": 3}
    t = ToolResponse.from_text("hello")
    assert t.content[0].type == "text" and t.first_json() is None
    e = ToolResponse.from_error("bad", hint="x")
    assert not e.success and e.first_json() == {"hint": "x"}
    with pytest.raises(ValidationError):
        Out(a="x")
    assert Out(a=3, extra=1).model_dump() == {"a": 3}  # outputs ignore extras, as pydantic's


def test_tools_default_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        default_tools(config=EmbeddingConfig(provider="hash", dim=8))


# ----------------------------------------------------- copies that must not drift


def test_corpus_gen_copy_is_byte_equal():
    for kw in ({}, {"n_episodes": 9, "chunks_per_episode": 5, "seed": 3,
                    "show_name": "S", "episode_names": ["a", "b"]}):
        assert [vars(c) for c in corpus_gen.generate_corpus(**kw)] == [
            vars(c) for c in jcorpus.generate_corpus(**kw)]
    chunks = corpus_gen.generate_corpus(4, 4)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    assert [corpus_gen.make_query(c, r1) for c in chunks] == [
        jcorpus.make_query(c, r2) for c in chunks]
    assert corpus_gen.split_by_episode(chunks) == jcorpus.split_by_episode(chunks)
    idx = list(range(len(chunks)))
    assert corpus_gen.training_pairs(chunks, idx, 6) == jcorpus.training_pairs(chunks, idx, 6)


def test_storage_copy_matches(transcripts_dir, tmp_path):
    (tmp_path / "transcripts" / "Other_Show" / "2024" / "broken_transcript.json").write_text("{")
    (tmp_path / "transcripts" / "Other_Show" / "notes.txt").write_text("x")
    t, j = LocalTranscriptStore(transcripts_dir), JStore(transcripts_dir)
    assert t.list_shows() == j.list_shows()
    for show in t.list_shows() + ["ghost"]:
        assert t.read_show(show) == j.read_show(show)
    assert LocalTranscriptStore(str(tmp_path / "missing")).list_shows() == []
    with pytest.raises(ValueError):
        get_store("ftp")


# ----------------------------------------------- the slice, trained, on the CPU


def test_trained_ingest_and_search_match_jax(tmp_path):
    """corpus_gen transcripts -> ProcessTranscriptsToEmbeddings with the
    shipped bi-encoder -> SearchIndex (plain and reranked), through both
    packages' tools: the stored vectors agree within 1e-5 and the hits
    are the same rows."""
    chunks = corpus_gen.generate_corpus(6, 8, seed=0)
    root = tmp_path / "transcripts"
    for i, c in enumerate(chunks):
        d = root / "Piers_Morgan_Uncensored" / f"ep{c.episode}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"c{i:03d}_transcript.json").write_text(json.dumps({"text": c.text}))
    kw = dict(provider="trained", model="artifacts/bi_encoder", dim=128)
    tsvc = ToolService()
    tsvc.register_tools(default_tools(store=LocalTranscriptStore(str(root)),
                                      config=EmbeddingConfig(**kw), device="cpu"))
    jsvc = JToolService()
    jsvc.register_tools(j_default_tools(store=JStore(str(root)), config=JEmbeddingConfig(**kw)))
    paths = {}
    for name, svc in (("torch", tsvc), ("jax", jsvc)):
        paths[name] = str(tmp_path / f"{name}.faiss")
        resp = svc.execute_tool_sync("ProcessTranscriptsToEmbeddings", {
            "show_name": "Piers_Morgan_Uncensored", "index_path": paths[name]})
        assert resp.success, resp.error
        assert resp.first_json()["embeddings_created"] == len(chunks)
    tv = faiss_io.read_flat_index(paths["torch"]).vectors
    jv = faiss_io.read_flat_index(paths["jax"]).vectors
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    assert faiss_io.read_metadata(paths["torch"]) == faiss_io.read_metadata(paths["jax"])
    rng = np.random.RandomState(0)
    for i in (3, 17, 40):
        q = corpus_gen.make_query(chunks[i], rng)
        for rerank in (False, True):
            args = {"query": q, "k": 5, "rerank": rerank}
            got = tsvc.execute_tool_sync("SearchIndex", {"index_path": paths["torch"], **args})
            want = jsvc.execute_tool_sync("SearchIndex", {"index_path": paths["jax"], **args})
            assert got.success and want.success, (got.error, want.error)
            g, w = got.first_json()["hits"], want.first_json()["hits"]
            assert [h["index"] for h in g] == [h["index"] for h in w]
            np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                       rtol=1e-4, atol=1e-5)
