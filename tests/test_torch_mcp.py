"""The port's MCP server, client and orchestrators
(``qrag_tpu_torch.serving.mcp_server`` / ``mcp_client`` /
``llm_orchestrator``) over real HTTP: the cases of the reference's
``tests/test_mcp.py``, ``test_mcp_conformance.py`` (the same golden
wire transcript) and ``test_mcp_streaming.py``; the ``tools/list``
payload of the two servers equal as JSON; ``--reload`` re-executing on
a source change of the port; the CLIs' ``--device`` and trained
provider.
"""

import http.client
import json
import os
import re
import sys
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_mcp_conformance import FIXTURE, _match, _post

from qrag_tpu.config import EmbeddingConfig as JEmbeddingConfig
from qrag_tpu.pipeline.storage import LocalTranscriptStore as JStore
from qrag_tpu.serving import mcp_server as jmcp
from qrag_tpu_torch.config import EmbeddingConfig, QragConfig
from qrag_tpu_torch.engine import QragEngine
from qrag_tpu_torch.index import faiss_io
from qrag_tpu_torch.pipeline.storage import LocalTranscriptStore
from qrag_tpu_torch.serving import devreload, http_app
from qrag_tpu_torch.serving import mcp_server as tmcp
from qrag_tpu_torch.serving.mcp_client import (
    McpClient,
    RuleBasedOrchestrator,
    make_orchestrator,
    render_tool_table,
)
from qrag_tpu_torch.serving.mcp_server import create_tool_service, serve_in_thread

_HEX32 = re.compile(r"^[0-9a-f]{32}$")


def _transcripts(root, episodes, text):
    d = root / "My_Show" / "2024"
    d.mkdir(parents=True)
    for ep in episodes:
        (d / f"{ep}_transcript.json").write_text(json.dumps({"transcript": text.replace("{}", ep)}))
    return str(root)


@pytest.fixture()
def mcp_setup(tmp_path):
    root = _transcripts(tmp_path / "transcripts", ("one", "two", "three"),
                        "episode {} talks about things " * 10)
    service = create_tool_service(store=LocalTranscriptStore(root),
                                  config=EmbeddingConfig(provider="hash", dim=32), device="cpu")
    server = serve_in_thread(service)
    yield McpClient(f"http://127.0.0.1:{server.server_address[1]}/mcp"), str(tmp_path)
    server.shutdown()
    server.server_close()


# ------------------------------------------------------------ test_mcp.py


def test_initialize(mcp_setup):
    client, _ = mcp_setup
    info = client.initialize()
    assert info["serverInfo"]["name"] == "qrag-mcp-server"
    assert "tools" in info["capabilities"]


def test_tools_list(mcp_setup):
    client, _ = mcp_setup
    tools = client.list_tools()
    assert [t["name"] for t in tools] == ["FetchEmbeddings", "ReadFromS3", "StoreInFaiss",
                                         "ProcessTranscriptsToEmbeddings", "SearchIndex"]
    assert "properties" in tools[0]["inputSchema"]
    table = render_tool_table(tools)
    assert "SearchIndex" in table and table.startswith("┌")


def test_tools_list_equals_reference_server(mcp_setup, tmp_path):
    """The two servers' ``tools/list`` payloads, as JSON text."""
    client, _ = mcp_setup
    jservice = jmcp.create_tool_service(store=JStore(str(tmp_path)),
                                        config=JEmbeddingConfig(provider="hash", dim=32))
    jserver = jmcp.serve_in_thread(jservice)
    try:
        jclient = McpClient(f"http://127.0.0.1:{jserver.server_address[1]}/mcp")
        assert json.dumps(client.list_tools()) == json.dumps(jclient.list_tools())
        assert client.initialize() == jclient.initialize()
    finally:
        jserver.shutdown()
        jserver.server_close()


def test_tools_call_roundtrip(mcp_setup):
    client, _ = mcp_setup
    ok, payload = client.call_tool("ReadFromS3", {})
    assert ok and payload["available_shows"] == ["My_Show"]


def test_tools_call_error_payload(mcp_setup):
    client, _ = mcp_setup
    ok, payload = client.call_tool("ReadFromS3", {"show_name": "ghost"})
    assert not ok and "error" in payload
    assert payload["available_shows"] == ["My_Show"]


def test_unknown_method(mcp_setup):
    client, _ = mcp_setup
    with pytest.raises(RuntimeError, match="method not found"):
        client._rpc("bogus/method")


def test_orchestrator_list_shows(mcp_setup):
    client, _ = mcp_setup
    assert "My_Show" in RuleBasedOrchestrator(client).run("list shows")


def test_orchestrator_index_show_with_fuzzy_retry(mcp_setup):
    client, tmp = mcp_setup
    out = RuleBasedOrchestrator(client, index_path=f"{tmp}/o.faiss").run("index my show")
    assert "Indexed show 'My_Show'" in out and "3 embeddings" in out
    assert faiss_io.read_flat_index(f"{tmp}/o.faiss").ntotal == 3


def test_orchestrator_unknown_intent(mcp_setup):
    client, _ = mcp_setup
    assert "list shows" in RuleBasedOrchestrator(client).run("make me a sandwich")


def test_full_loop_ingest_then_serve(mcp_setup):
    client, tmp = mcp_setup
    ok, _ = client.call_tool("ProcessTranscriptsToEmbeddings",
                             {"show_name": "My_Show", "index_path": f"{tmp}/full.faiss"})
    assert ok
    eng = QragEngine.from_faiss(
        f"{tmp}/full.faiss",
        config=QragConfig.from_dict({"embedding": {"provider": "hash", "dim": 32}}),
        device="cpu",
    )
    res = eng.search("episode two talks about things " * 10, k=1)
    assert res.metadata[0][0] == "My_Show/two_transcript"


def test_orchestrator_preserves_path_case(mcp_setup):
    client, tmp = mcp_setup
    out = RuleBasedOrchestrator(client).run(f"index My_Show into {tmp}/CamelCase.faiss")
    assert "Indexed show" in out
    assert os.path.exists(f"{tmp}/CamelCase.faiss")
    assert not os.path.exists(f"{tmp}/camelcase.faiss")


def test_resources_and_prompts_stubs(mcp_setup):
    client, _ = mcp_setup
    assert client._rpc("resources/list") == {"resources": []}
    assert client._rpc("prompts/list") == {"prompts": []}


def test_orchestrator_search_intent(mcp_setup):
    client, tmp = mcp_setup
    orch = RuleBasedOrchestrator(client, index_path=f"{tmp}/s.faiss")
    orch.run("index My_Show")
    out = orch.run("search episode two talks in " + f"{tmp}/s.faiss")
    assert "Top" in out and "My_Show/two_transcript" in out


def test_make_orchestrator_without_openai(mcp_setup):
    client, _ = mcp_setup
    try:
        import openai  # noqa: F401

        pytest.skip("openai is installed")
    except ImportError:
        pass
    assert isinstance(make_orchestrator(client, "rules"), RuleBasedOrchestrator)
    assert isinstance(make_orchestrator(client, "auto"), RuleBasedOrchestrator)
    with pytest.raises(RuntimeError, match="openai"):
        make_orchestrator(client, "openai")


# ------------------------------------------------ test_mcp_conformance.py


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = _transcripts(tmp_path_factory.mktemp("transcripts"), ("one", "two"),
                        "episode {} talks about things " * 8)
    service = create_tool_service(store=LocalTranscriptStore(root),
                                  config=EmbeddingConfig(provider="hash", dim=32), device="cpu")
    srv = serve_in_thread(service)
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def test_golden_exchanges(server, golden):
    for ex in golden["exchanges"]:
        status, headers, data = _post(server, json.dumps(ex["request"]).encode())
        assert status == 200, f"{ex['name']}: HTTP {status}"
        _match(ex["response"], json.loads(data), f"$({ex['name']})")
        for hk, hv in (ex.get("response_headers") or {}).items():
            got = headers.get(hk)
            assert got is not None, f"{ex['name']}: missing header {hk}"
            _match(hv, got if hk != "Content-Type" else got.split(";")[0])


def test_parse_error_contract(server, golden):
    spec = golden["parse_error"]
    status, _, data = _post(server, spec["raw_request_body"].encode())
    assert status == spec["response_status"]
    _match(spec["response"], json.loads(data))


def test_http_transport_contract(server, golden):
    spec = golden["http"]
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("GET", "/mcp")
    r = conn.getresponse()
    r.read()
    assert r.status == spec["get_mcp_status"] and r.getheader("Allow") == spec["get_mcp_allow"]
    conn.close()
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("OPTIONS", "/mcp")
    r = conn.getresponse()
    r.read()
    assert r.status == spec["options_status"]
    assert r.getheader("Access-Control-Allow-Origin") == spec["cors_allow_origin"]
    conn.close()
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("GET", "/tools")
    r = conn.getresponse()
    assert [t["name"] for t in json.loads(r.read())["tools"]][-1] == "SearchIndex"
    conn.close()


def test_sse_framing_contract(server, golden):
    spec = golden["sse"]
    tmp = tempfile.mkdtemp(prefix="mcp_golden_")
    req_body = json.dumps(spec["request"]).replace("<TMPDIR>", tmp)
    conn = http.client.HTTPConnection(*server, timeout=60)
    conn.request("POST", "/mcp", body=req_body.encode(),
                 headers={"Content-Type": "application/json", "Accept": "text/event-stream"})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
    raw = resp.read()
    conn.close()
    events = []
    for fr in [f for f in raw.split(b"\r\n\r\n") if f]:
        lines = fr.split(b"\r\n")
        assert lines[0] == f"event: {spec['event_name']}".encode(), lines[0]
        assert lines[1].startswith(b"data: ")
        events.append(json.loads(lines[1][len(b"data: "):]))
    assert len(events) >= spec["min_progress_events"] + 1
    token = spec["request"]["params"]["_meta"]["progressToken"]
    last = -1.0
    for note in events[:-1]:
        assert note["jsonrpc"] == "2.0" and note["method"] == "notifications/progress"
        assert "id" not in note and note["params"]["progressToken"] == token
        assert note["params"]["progress"] >= last
        last = note["params"]["progress"]
    _match(spec["final_response"], events[-1], "$final")


def test_sse_initialize_session_header(server):
    conn = http.client.HTTPConnection(*server, timeout=30)
    conn.request("POST", "/mcp", body=json.dumps(
        {"jsonrpc": "2.0", "id": 0, "method": "initialize", "params": {}}).encode(),
        headers={"Content-Type": "application/json", "Accept": "text/event-stream"})
    resp = conn.getresponse()
    sid = resp.getheader("Mcp-Session-Id")
    assert sid and _HEX32.match(sid)
    body = resp.read()
    conn.close()
    final = json.loads([f for f in body.split(b"\r\n\r\n") if f][-1].split(b"\r\n")[1][6:])
    assert final["result"]["protocolVersion"] == "2024-11-05"


# -------------------------------------------------- test_mcp_streaming.py


@pytest.fixture()
def mcp_url(tmp_path):
    root = _transcripts(tmp_path / "transcripts", ("one", "two", "three", "four"),
                        "episode {} content " * 20)
    service = create_tool_service(store=LocalTranscriptStore(root),
                                  config=EmbeddingConfig(provider="hash", dim=16), device="cpu")
    server = serve_in_thread(service)
    yield f"http://127.0.0.1:{server.server_address[1]}/mcp", str(tmp_path)
    server.shutdown()
    server.server_close()


def _raw_post(url, payload, accept):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", "Accept": accept},
                                 method="POST")
    return urllib.request.urlopen(req)


def _parse_sse(resp):
    msgs, data_lines = [], []
    for raw in resp:
        line = raw.decode().rstrip("\r\n")
        if line.startswith("data:"):
            data_lines.append(line[5:].strip())
        elif not line and data_lines:
            msgs.append(json.loads("\n".join(data_lines)))
            data_lines = []
    return msgs


def test_sse_stream_with_progress(mcp_url):
    url, tmp = mcp_url
    payload = {"jsonrpc": "2.0", "id": 42, "method": "tools/call", "params": {
        "name": "ProcessTranscriptsToEmbeddings",
        "arguments": {"show_name": "My_Show", "index_path": f"{tmp}/stream.faiss"},
        "_meta": {"progressToken": 42}}}
    resp = _raw_post(url, payload, "application/json, text/event-stream")
    assert "text/event-stream" in resp.headers.get("Content-Type", "")
    msgs = _parse_sse(resp)
    notes = [m for m in msgs if m.get("method") == "notifications/progress"]
    finals = [m for m in msgs if "id" in m]
    assert len(notes) >= 3, msgs
    assert all(n["params"]["progressToken"] == 42 for n in notes)
    progs = [n["params"]["progress"] for n in notes]
    assert progs == sorted(progs)
    assert msgs[-1] is finals[-1] and finals[-1]["id"] == 42
    result = finals[-1]["result"]
    assert not result["isError"]
    assert json.loads(result["content"][0]["text"])["embeddings_created"] == 4


def test_sse_without_token_still_streams_response(mcp_url):
    url, _ = mcp_url
    msgs = _parse_sse(_raw_post(url, {"jsonrpc": "2.0", "id": 7, "method": "tools/list",
                                      "params": {}}, "text/event-stream"))
    assert len(msgs) == 1 and msgs[0]["id"] == 7
    assert len(msgs[0]["result"]["tools"]) == 5


def test_json_fallback_unchanged(mcp_url):
    url, _ = mcp_url
    resp = _raw_post(url, {"jsonrpc": "2.0", "id": 1, "method": "ping", "params": {}},
                     "application/json")
    assert "application/json" in resp.headers.get("Content-Type", "")
    assert json.loads(resp.read())["result"] == {}


def test_session_id_assigned_on_initialize(mcp_url):
    url, _ = mcp_url
    resp = _raw_post(url, {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
                     "application/json")
    sid = resp.headers.get("Mcp-Session-Id")
    assert sid and len(sid) == 32


def test_get_mcp_is_405(mcp_url):
    url, _ = mcp_url
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url)
    assert e.value.code == 405


def test_client_surfaces_progress(mcp_url):
    url, tmp = mcp_url
    seen = []
    client = McpClient(url, stream=True, on_progress=lambda p, t, m: seen.append((p, t, m)))
    client.initialize()
    assert client.session_id
    ok, payload = client.call_tool("ProcessTranscriptsToEmbeddings",
                                   {"show_name": "My_Show", "index_path": f"{tmp}/cli.faiss"})
    assert ok and payload["embeddings_created"] == 4
    assert len(seen) >= 3 and any("embedding" in (m or "") for _, _, m in seen)


def test_nonstream_client_against_streaming_server(mcp_url):
    url, _ = mcp_url
    ok, payload = McpClient(url, stream=False).call_tool("ReadFromS3", {})
    assert ok and payload["available_shows"] == ["My_Show"]


def test_streamed_dispatch_error_keeps_jsonrpc_contract(mcp_url):
    url, _ = mcp_url
    msgs = _parse_sse(_raw_post(url, {"jsonrpc": "2.0", "id": 9, "method": "tools/call",
                                      "params": ["not", "a", "dict"]}, "text/event-stream"))
    assert msgs[-1]["id"] == 9 and msgs[-1]["error"]["code"] == -32603


# ---------------------------------------------------------- CLIs and reload


class _FakeServer:
    def __init__(self, *args, **kwargs):
        self.args = args

    def serve_forever(self):
        pass


def test_mcp_server_cli_device_and_trained(monkeypatch):
    """``--device`` places the tools; ``--embedding-provider trained``
    with ``--embedding-model`` loads the bi-encoder there."""
    made = []

    def fake_create_server(service, host, port):
        made.append(service)
        return _FakeServer()

    monkeypatch.setattr(tmcp, "create_server", fake_create_server)
    tmcp.main(["--device", "cpu", "--port", "0", "--embedding-provider", "trained",
               "--embedding-model", "artifacts/bi_encoder"])
    search = made[0].get_tool("SearchIndex")
    assert str(search.device) == "cpu" and search.embedder.dim == 128
    assert made[0].get_tool("FetchEmbeddings").embedder is search.embedder
    with pytest.raises(SystemExit):
        tmcp.main(["--embedding-provider", "bogus"])


@pytest.mark.parametrize("cli", ["mcp", "http"])
def test_reload_flag_starts_the_reloader(monkeypatch, cli):
    started = []
    monkeypatch.setattr(devreload, "start_reloader", lambda *a, **k: started.append(a))
    if cli == "mcp":
        monkeypatch.setattr(tmcp, "create_server", lambda *a, **k: _FakeServer())
        tmcp.main(["--device", "cpu", "--port", "0", "--reload"])
    else:
        monkeypatch.setattr(http_app, "create_server", lambda *a, **k: _FakeServer())
        monkeypatch.setattr(http_app, "configure_logging", lambda: None)
        http_app.main(["--device", "cpu", "--port", "0", "--no-warmup", "--reload",
                       "--embedding-provider", "trained"])
    assert started == [()]


def test_http_cli_trained_provider(monkeypatch):
    """``--embedding-provider trained`` with QRAG_EMBEDDING_MODEL serves
    the shipped bi-encoder on the engine's device."""
    engines = []
    monkeypatch.setattr(http_app, "create_server",
                        lambda engine, *a, **k: engines.append(engine) or _FakeServer())
    monkeypatch.setattr(http_app, "configure_logging", lambda: None)
    monkeypatch.setenv("QRAG_EMBEDDING_MODEL", "artifacts/bi_encoder")
    monkeypatch.setenv("QRAG_EMBEDDING_DIM", "128")
    http_app.main(["--device", "cpu", "--port", "0", "--no-warmup",
                   "--embedding-provider", "trained"])
    emb = engines[0].embedder
    assert type(emb).__name__ == "TrainedEmbedder" and str(emb.device) == "cpu"
    assert emb(["hello"]).shape == (1, 128)


def test_reloader_reexecs_on_source_change(monkeypatch, tmp_path):
    """A changed .py file under a watched root re-executes the process
    with its own argv; the port's package is watched."""
    watched = []
    real = devreload._source_mtimes
    monkeypatch.setattr(devreload, "_source_mtimes",
                        lambda roots: watched.append(list(roots)) or real(roots))
    src = tmp_path / "mod.py"
    src.write_text("x = 1\n")
    execs, fired, release = [], threading.Event(), threading.Event()

    def fake_execv(exe, argv):
        execs.append((exe, argv))
        fired.set()
        release.wait(30)
        raise SystemExit  # ends the watcher thread quietly

    monkeypatch.setattr(devreload.os, "execv", fake_execv)
    hook = threading.excepthook  # as the interpreter's own hook, ignore SystemExit
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: None if args.exc_type is SystemExit else hook(args))
    thread = devreload.start_reloader(extra_roots=[str(tmp_path)], poll_s=0.05)
    try:
        assert not fired.wait(0.3)  # nothing changed yet
        os.utime(src, (1, 1))  # a new mtime
        assert fired.wait(10)
    finally:
        release.set()
        thread.join(10)
    assert not thread.is_alive()
    assert execs == [(sys.executable, [sys.executable] + sys.argv)]
    import qrag_tpu_torch

    assert watched[0][0] == os.path.dirname(qrag_tpu_torch.__file__)
    assert str(tmp_path) in watched[0]
    assert np.all([len(w) == 2 for w in watched])
