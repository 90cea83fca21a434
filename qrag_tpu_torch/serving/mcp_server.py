"""MCP server — JSON-RPC 2.0 over streamable HTTP, stdlib only (the
port's counterpart of ``qrag_tpu.serving.mcp_server``; the same wire
format, with the port's tools on ``device``).

The reference wraps FastMCP's streamable-HTTP app around its four
tools on port 6969 (``mcp/server/server.py:16-71``); its client speaks
the HTTP-stream transport (``mcp/client/main.py:54``).  FastMCP isn't
available here, so this is a from-scratch implementation of the MCP
wire surface those clients use:

  POST /mcp   JSON-RPC 2.0:
    initialize      → protocol + server info + capability; assigns an
                      ``Mcp-Session-Id`` response header
    tools/list      → [{name, description, inputSchema}]
    tools/call      → {content: [{type: "text", text}], isError}
    ping            → {}

  Transport negotiation (streamable HTTP): when the request's Accept
  header includes ``text/event-stream``, the response is a chunked SSE
  stream — ``notifications/progress`` events (if the request carried a
  ``params._meta.progressToken`` and the tool reports progress via
  ``tools.progress``) followed by one final ``message`` event holding
  the JSON-RPC response.  Plain JSON stays the fallback.  GET /mcp
  returns 405 (no server-initiated streams), which the spec permits.

  GET /tools        → convenience schema listing (non-MCP)

Tool dispatch goes through the typed ``ToolService`` (closures, not
the reference's exec-generated handlers — SURVEY.md Appendix A.8).
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from qrag_tpu_torch.tools import ToolService, default_tools
from qrag_tpu_torch.tools.interface import ToolResponse
from qrag_tpu_torch.tools.progress import progress_scope
from qrag_tpu_torch.utils.logging_util import configure_logging

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "qrag-mcp-server", "version": "0.1.0"}
DEFAULT_PORT = 6969  # reference default (server.py argparse)


def create_tool_service(**kwargs) -> ToolService:
    """The default tools (``default_tools``'s keywords: store,
    embedder, config, device; the device defaults to CUDA)."""
    service = ToolService()
    service.register_tools(default_tools(**kwargs))
    return service


def _tool_result(resp: ToolResponse) -> Dict[str, Any]:
    """Map a ToolResponse onto the MCP tools/call result shape."""
    blocks = []
    for c in resp.content:
        if c.type == "text" and c.text is not None:
            blocks.append({"type": "text", "text": c.text})
        elif c.data is not None:
            blocks.append({"type": "text", "text": json.dumps(c.data)})
    if resp.error:
        blocks.insert(0, {"type": "text", "text": f"error: {resp.error}"})
    return {"content": blocks, "isError": not resp.success}


def _make_handler(service: ToolService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        _new_session_id: Optional[str] = None  # set by initialize

        def _send(self, payload: Dict[str, Any], status: int = 200) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self._new_session_id:
                self.send_header("Mcp-Session-Id", self._new_session_id)
                self._new_session_id = None
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            logger.debug("%s %s", self.address_string(), fmt % args)

        def do_OPTIONS(self):
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            if self.path == "/tools":
                self._send({"tools": service.list_schemas()})
            elif self.path in ("/mcp", "/mcp/"):
                # no server-initiated streams; 405 is spec-conformant
                self.send_response(405)
                self.send_header("Allow", "POST, OPTIONS")
                self.send_header("Content-Length", "0")
                self.end_headers()
            else:
                self._send({"error": f"not found: {self.path}"}, 404)

        # ----------------------------------------------- SSE framing

        def _start_sse(self, session_id: Optional[str] = None) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            if session_id:
                self.send_header("Mcp-Session-Id", session_id)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _sse_event(self, data: Dict[str, Any], event: str = "message") -> None:
            payload = (
                f"event: {event}\r\ndata: {json.dumps(data)}\r\n\r\n".encode()
            )
            self.wfile.write(f"{len(payload):X}\r\n".encode())
            self.wfile.write(payload + b"\r\n")
            self.wfile.flush()

        def _end_chunked(self) -> None:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        def do_POST(self):
            if self.path not in ("/mcp", "/mcp/"):
                self._send({"error": f"not found: {self.path}"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
            except Exception as e:  # noqa: BLE001
                self._send(
                    {
                        "jsonrpc": "2.0",
                        "id": None,
                        "error": {"code": -32700, "message": f"parse error: {e}"},
                    },
                    400,
                )
                return
            wants_stream = "text/event-stream" in (
                self.headers.get("Accept") or ""
            )
            if wants_stream and isinstance(req, dict):
                self._stream_response(req)
            else:
                self._send(self._dispatch(req))

        def _stream_response(self, req: Dict[str, Any]) -> None:
            """Streamable-HTTP arm: progress notifications (when the
            request carries a progressToken and the tool reports) then
            the final JSON-RPC response, as SSE ``message`` events."""
            params = req.get("params") or {}
            if not isinstance(params, dict):
                params = {}  # malformed params still get a response
            token = (params.get("_meta") or {}).get("progressToken")
            # the session header must go out before the body; assign it
            # here for streamed initialize (the JSON arm assigns in
            # _dispatch, whose header hasn't been sent yet there)
            sid = uuid.uuid4().hex if req.get("method") == "initialize" else None
            self._start_sse(session_id=sid)
            events: "queue.Queue[Optional[Dict[str, Any]]]" = queue.Queue()

            def on_progress(progress, total, message):
                note = {
                    "jsonrpc": "2.0",
                    "method": "notifications/progress",
                    "params": {
                        "progressToken": token,
                        "progress": progress,
                        **({"total": total} if total is not None else {}),
                        **({"message": message} if message else {}),
                    },
                }
                events.put(note)

            result: Dict[str, Any] = {}

            def work():
                try:
                    if token is not None:
                        with progress_scope(on_progress):
                            result.update(self._dispatch(req))
                    else:
                        result.update(self._dispatch(req))
                except Exception as e:  # noqa: BLE001 - keep the
                    # JSON-RPC error contract on the streaming arm too
                    logger.exception("streamed dispatch failed")
                    result.update(
                        {
                            "jsonrpc": "2.0",
                            "id": req.get("id"),
                            "error": {
                                "code": -32603,
                                "message": f"internal error: {e}",
                            },
                        }
                    )
                finally:
                    events.put(None)  # sentinel: dispatch finished

            t = threading.Thread(target=work, daemon=True)
            t.start()
            try:
                while True:
                    item = events.get()
                    if item is None:
                        break
                    self._sse_event(item)
                t.join()
                self._sse_event(result)
                self._end_chunked()
            except (BrokenPipeError, ConnectionResetError):
                logger.debug("SSE client disconnected mid-stream")
            finally:
                # keep-alive connections reuse this handler instance:
                # don't leak a dispatch-assigned session id into the
                # next response's headers
                self._new_session_id = None

        def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
            rpc_id = req.get("id")
            method = req.get("method")
            params = req.get("params") or {}

            def ok(result):
                return {"jsonrpc": "2.0", "id": rpc_id, "result": result}

            def err(code, message):
                return {
                    "jsonrpc": "2.0",
                    "id": rpc_id,
                    "error": {"code": code, "message": message},
                }

            if method == "initialize":
                # streamable-HTTP session handshake: assign an id the
                # client echoes in Mcp-Session-Id on later requests
                self._new_session_id = uuid.uuid4().hex
                return ok(
                    {
                        "protocolVersion": PROTOCOL_VERSION,
                        "capabilities": {"tools": {}},
                        "serverInfo": SERVER_INFO,
                    }
                )
            if method in ("ping", "notifications/initialized"):
                return ok({})
            if method == "tools/list":
                return ok(
                    {
                        "tools": [
                            {
                                "name": t.name,
                                "description": t.description,
                                "inputSchema": t.input_model.model_json_schema(),
                            }
                            for t in service.tools
                        ]
                    }
                )
            if method in ("resources/list", "prompts/list"):
                # protocol politeness: we expose no resources/prompts,
                # but spec-conformant clients may enumerate them
                key = method.split("/")[0]
                return ok({key: []})
            if method == "tools/call":
                name = params.get("name")
                arguments = params.get("arguments") or {}
                if not name:
                    return err(-32602, "missing tool name")
                resp = service.execute_tool_sync(name, arguments)
                return ok(_tool_result(resp))
            return err(-32601, f"method not found: {method}")

    return Handler


def create_server(
    service: Optional[ToolService] = None,
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
) -> ThreadingHTTPServer:
    service = service or create_tool_service()
    return ThreadingHTTPServer((host, port), _make_handler(service))


def serve_in_thread(
    service: Optional[ToolService] = None,
    host: str = "127.0.0.1",
    port: int = 0,
) -> ThreadingHTTPServer:
    server = create_server(service, host, port)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="qrag_tpu_torch MCP server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    parser.add_argument(
        "--transcripts", default=None, help="local transcript root dir"
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument(
        "--embedding-provider",
        default="hash",
        choices=["mock", "hash", "openai", "trained"],
    )
    parser.add_argument(
        "--embedding-model",
        default=None,
        help="the provider's model; for 'trained', the bi-encoder's weights "
        "directory (e.g. artifacts/bi_encoder)",
    )
    parser.add_argument(
        "--reload",
        action="store_true",
        help="dev auto-reload: re-exec on source change (server.py:56-62 parity)",
    )
    args = parser.parse_args(argv)
    configure_logging()
    if args.reload:
        from qrag_tpu_torch.serving.devreload import start_reloader

        start_reloader()

    from qrag_tpu_torch.config import EmbeddingConfig
    from qrag_tpu_torch.pipeline.storage import LocalTranscriptStore

    store = LocalTranscriptStore(args.transcripts) if args.transcripts else None
    config = EmbeddingConfig(provider=args.embedding_provider)
    if args.embedding_model:
        config.model = args.embedding_model
    service = create_tool_service(store=store, config=config, device=args.device)
    logger.info(
        "MCP server on %s:%d with tools: %s",
        args.host,
        args.port,
        [t.name for t in service.tools],
    )
    create_server(service, args.host, args.port).serve_forever()


if __name__ == "__main__":
    main()
