"""HTTP serving layer for the PyTorch port — stdlib only.

The surface and the request/response shapes of
``qrag_tpu.serving.http_app``:

  POST /search         — {query: str | queries: [str] | vectors: [[f]],
                         k?, stream?} -> top-k over the device index;
                         ``stream: true`` returns chunked NDJSON (hits
                         in <=512-row spans + a final {"done": true})
  POST /search_rerank  — fused retrieval -> quantum-fidelity rerank
  POST /add            — {texts: [str], metadata?: [str]} ingestion
  GET  /               — service info
  GET  /stats          — counters + latency histograms

Handler-level failures return ``{"error": str}`` with HTTP 200 (the
reference's behavior), 400/404 for protocol problems.  ``POST /rerank``
answers 501: the document-list rerank is not ported yet (ROADMAP.md,
Queue 1 slice 2), and neither are ``--batching``, ``--sharded`` and
``--elastic``.  Requests run on the handler threads, each launching
the kernels on its own current CUDA stream.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from qrag_tpu.config import QragConfig
from qrag_tpu.utils.logging_util import configure_logging
from qrag_tpu_torch.engine import QragEngine, _index_cls_and_kwargs

logger = logging.getLogger(__name__)

SERVICE_INFO = {
    "message": "qrag_tpu_torch retrieval + rerank API",
    "version": "0.1.0",
    "use_case": "Podcast advertisement detection",
    "endpoints": {
        "search": "POST /search - exact top-k over the device-resident index",
        "search_rerank": "POST /search_rerank - fused retrieval + quantum rerank",
        "add": "POST /add - embed + ingest texts",
        "stats": "GET /stats - metrics snapshot",
    },
}

_NOT_PORTED = "not ported to qrag_tpu_torch yet (ROADMAP.md, Queue 1 slice 2)"


def _make_handler(engine: QragEngine):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send_json(self, payload: Dict[str, Any], status: int = 200) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> Optional[Dict[str, Any]]:
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b"{}"
                data = json.loads(raw)
                if not isinstance(data, dict):
                    raise ValueError("body must be a JSON object")
                return data
            except ValueError as e:  # json.JSONDecodeError is a ValueError
                self._send_json({"error": f"invalid JSON body: {e}"}, 400)
                return None

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s %s", self.address_string(), fmt % args)

        def do_OPTIONS(self):  # CORS preflight
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            if self.path == "/":
                self._send_json(SERVICE_INFO)
            elif self.path.startswith("/stats"):
                self._send_json(engine.stats())
            else:
                self._send_json({"error": f"not found: {self.path}"}, 404)

        def do_POST(self):
            body = self._read_json()
            if body is None:
                return
            try:
                if self.path == "/rerank":
                    self._send_json({"error": f"POST /rerank is {_NOT_PORTED}"}, 501)
                elif self.path == "/search" and body.get("stream"):
                    self._stream_search(body)
                elif self.path == "/search":
                    self._send_json(self._handle_search(body))
                elif self.path == "/search_rerank":
                    self._send_json(self._handle_search_rerank(body))
                elif self.path == "/add":
                    self._send_json(self._handle_add(body))
                else:
                    self._send_json({"error": f"not found: {self.path}"}, 404)
            except Exception as e:  # noqa: BLE001 - reference app.py:75-77
                logger.exception("error during request")
                self._send_json({"error": str(e)})

        def _search_result(self, body: Dict[str, Any]):
            """Parse the queries of /search and run them.  Returns
            (SearchResult, None) or (None, error dict)."""
            k = int(body.get("k", 10))
            if "vectors" in body:
                queries = np.asarray(body["vectors"], dtype=np.float32)
            elif "queries" in body:
                queries = list(body["queries"])
            elif "query" in body:
                queries = [body["query"]]
            else:
                return None, {"error": "provide query, queries, or vectors"}
            return engine.search(queries, k=k), None

        def _stream_search(self, body: Dict[str, Any]) -> None:
            """Chunked NDJSON: ``{"query", "offset", "hits"}`` lines of
            <= 512 hits, then ``{"done": true, "metric": ...}``."""
            res, err = self._search_result(body)
            if err is not None:
                self._send_json(err)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj: Dict[str, Any]) -> None:
                line = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(line):X}\r\n".encode())
                self.wfile.write(line + b"\r\n")
                self.wfile.flush()

            # once headers are out, failures are reported IN-STREAM; a
            # second status line would corrupt the chunked framing
            try:
                span = 512
                for qi in range(res.indices.shape[0]):
                    hits = [
                        {"index": int(i), "score": float(s), "metadata": m}
                        for i, s, m in res.top(qi)
                    ]
                    for off in range(0, max(len(hits), 1), span):
                        chunk({"query": qi, "offset": off, "hits": hits[off : off + span]})
                chunk({"done": True, "metric": engine.index.metric})
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                logger.debug("stream client disconnected mid-response")
                self.close_connection = True
            except Exception as e:  # noqa: BLE001 - in-stream error line
                logger.exception("error mid-stream")
                try:
                    chunk({"error": str(e)})
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass
                self.close_connection = True

        def _handle_search(self, body: Dict[str, Any]) -> Dict[str, Any]:
            res, err = self._search_result(body)
            if err is not None:
                return err
            return {
                "results": [
                    [
                        {"index": int(i), "score": float(s), "metadata": m}
                        for i, s, m in res.top(q)
                    ]
                    for q in range(res.indices.shape[0])
                ],
                "metric": engine.index.metric,
            }

        def _handle_search_rerank(self, body: Dict[str, Any]) -> Dict[str, Any]:
            if "vectors" in body:
                queries = np.asarray(body["vectors"], dtype=np.float32)
            elif "query" in body:
                queries = [body["query"]]
            elif "queries" in body:
                queries = list(body["queries"])
            else:
                return {"error": "provide query, queries, or vectors"}
            return engine.search_rerank(
                queries,
                k=int(body.get("k", 10)),
                candidates=int(body.get("candidates", 100)),
                reranker_type=body.get("reranker_type", "quantum"),
            )

        def _handle_add(self, body: Dict[str, Any]) -> Dict[str, Any]:
            texts = body.get("texts")
            if not isinstance(texts, list) or not texts:
                return {"error": "texts must be a non-empty list"}
            ntotal = engine.add_texts([str(t) for t in texts], body.get("metadata"))
            return {"stored_count": len(texts), "total_vectors": ntotal}

    return Handler


def create_server(
    engine: QragEngine, host: str = "0.0.0.0", port: int = 8000
) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), _make_handler(engine))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="qrag_tpu_torch HTTP server")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--index", default=None, help=".faiss file or native dir")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument(
        "--embedding-provider", default=None, choices=["mock", "hash", "openai"]
    )
    parser.add_argument(
        "--topk-mode",
        default=None,
        choices=["exact", "bounded"],
        help="top-k selection mode: 'bounded' = provably-exact "
        "norm-bounded window pruning (ops/bounded_topk.py)",
    )
    parser.add_argument("--no-warmup", action="store_true")
    for flag in ("--batching", "--sharded", "--elastic"):
        parser.add_argument(flag, action="store_true", help=f"{_NOT_PORTED}")
    args = parser.parse_args(argv)
    for flag in ("batching", "sharded", "elastic"):
        if getattr(args, flag):
            parser.error(f"--{flag} is {_NOT_PORTED}")

    configure_logging()
    config = QragConfig().with_env_overrides()
    if args.topk_mode:
        config = replace(config, index=replace(config.index, topk_mode=args.topk_mode))
        # engine bundles re-read env overrides (QragEngine.load)
        os.environ["QRAG_INDEX_TOPK_MODE"] = args.topk_mode
    if args.embedding_provider:
        config = replace(
            config,
            embedding=replace(config.embedding, provider=args.embedding_provider),
        )
    host = args.host or config.serving.host
    port = args.port if args.port is not None else config.serving.port

    if args.index and os.path.isdir(args.index):
        if os.path.exists(os.path.join(args.index, "engine.json")):
            engine = QragEngine.load(args.index, device=args.device)
            if args.embedding_provider:
                from qrag_tpu.pipeline.embeddings import get_embedder

                engine.embedder = get_embedder(
                    replace(engine.config.embedding, provider=args.embedding_provider)
                )
        else:
            cls_, kw = _index_cls_and_kwargs(config)
            kw.pop("row_pad_multiple")
            index = cls_.load_native(args.index, device=args.device, **kw)
            engine = QragEngine(config=config, index=index)
    elif args.index:
        engine = QragEngine.from_faiss(args.index, config=config, device=args.device)
    else:
        engine = QragEngine(config=config, device=args.device)

    # bind before warmup so clients can connect immediately
    server = create_server(engine, host, port)
    if not args.no_warmup:
        threading.Thread(target=engine.warmup, daemon=True).start()
    logger.info("serving on %s:%d (index ntotal=%d)", host, port, engine.index.ntotal)
    server.serve_forever()


if __name__ == "__main__":
    main()
