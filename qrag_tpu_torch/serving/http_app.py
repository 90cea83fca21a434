"""HTTP serving layer for the PyTorch port — stdlib only.

The surface and the request/response shapes of
``qrag_tpu.serving.http_app``:

  POST /rerank         — {query, documents: [{id, content, source?}],
                         reranker_type?, top_k?} -> {documents:
                         [{document, score}], reranker_used, query}
  POST /search         — {query: str | queries: [str] | vectors: [[f]],
                         k?, stream?, priority?} -> top-k over the
                         device index; ``stream: true`` returns chunked
                         NDJSON (hits in <=512-row spans + a final
                         {"done": true})
  POST /search_rerank  — fused retrieval -> rerank (quantum, classical
                         or auto-routed)
  POST /add            — {texts: [str], metadata?: [str]} ingestion
  GET  /               — service info
  GET  /docs           — JSON API description
  GET  /stats          — counters + latency histograms (``?recall=1``
                         adds a sampled recall@10 self-check)

Handler-level failures return ``{"error": str}`` with HTTP 200 (the
reference's behavior), 400/404 for protocol problems.  ``--batching``
coalesces concurrent /search, /search_rerank (except "auto") and
/rerank requests into device batches (``serving/batcher.py``).
``--sharded`` shards the corpus rows over the mesh's slots (the mesh
from ``QRAG_MESH_*``: ``QRAG_MESH_MODEL_PARALLEL=4`` puts four shards on
one card), ``--shard-merge`` picks the merge, ``--elastic`` re-shards
over the surviving slots after a failure.  ``--bounded-scan int8`` and
``--lean-scan`` select the int8 retrieval modes; ``--small-batch-accel`` the clustered accelerator of
small batches.  Requests run on the handler threads, each launching
the kernels on its own current CUDA stream; with ``--batching`` the
batcher's worker thread runs the device calls.
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

from qrag_tpu_torch.config import QragConfig
from qrag_tpu_torch.documents import Document
from qrag_tpu_torch.engine import QragEngine, _index_cls_and_kwargs
from qrag_tpu_torch.pipeline.embeddings import get_embedder
from qrag_tpu_torch.reranker.controller import rerank_response_dict
from qrag_tpu_torch.serving.batcher import SearchBatcher
from qrag_tpu_torch.utils.logging_util import configure_logging

logger = logging.getLogger(__name__)

SERVICE_INFO = {
    "message": "qrag_tpu_torch retrieval + rerank API",
    "version": "0.1.0",
    "use_case": "Podcast advertisement detection",
    "endpoints": {
        "rerank": "POST /rerank - rerank documents (quantum/classical/auto)",
        "search": "POST /search - exact top-k over the device-resident index",
        "search_rerank": "POST /search_rerank - fused retrieval + quantum rerank",
        "add": "POST /add - embed + ingest texts",
        "stats": "GET /stats - metrics snapshot",
    },
}


API_DOCS = {
    "service": SERVICE_INFO["message"],
    "endpoints": {
        "POST /rerank": {
            "body": {
                "query": "str",
                "documents": [{"id": "str", "content": "str", "source": "str?"}],
                "reranker_type": "auto|quantum|classical",
                "top_k": "int?",
            },
        },
        "POST /search": {
            "body": {
                "query | queries | vectors": "...",
                "k": "int?",
                "stream": "bool? (chunked NDJSON)",
                "priority": "int? (-10..10)",
            },
        },
        "POST /search_rerank": {
            "body": {
                "query | queries | vectors": "...",
                "k": "int?",
                "candidates": "int?",
                "reranker_type": "quantum|classical|auto",
                "priority": "int? (-10..10)",
            },
        },
        "POST /add": {"body": {"texts": ["str"], "metadata": ["str?"]}},
        "GET /stats": {"query": "?recall=1"},
    },
}


def _make_handler(engine: QragEngine, batcher: Optional[SearchBatcher] = None):
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
            elif self.path == "/docs":
                self._send_json(API_DOCS)
            elif self.path.startswith("/stats"):
                stats = engine.stats()
                if batcher is not None:
                    stats["batcher"] = batcher.stats()
                if "recall" in self.path.partition("?")[2]:
                    stats["sampled_recall_at_10"] = engine.sample_recall(k=10)
                self._send_json(stats)
            else:
                self._send_json({"error": f"not found: {self.path}"}, 404)

        def do_POST(self):
            body = self._read_json()
            if body is None:
                return
            try:
                if self.path == "/rerank":
                    self._send_json(self._handle_rerank(body))
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

        def _handle_rerank(self, body: Dict[str, Any]) -> Dict[str, Any]:
            query = body.get("query")
            if not isinstance(query, str):
                return {"error": "query must be a string"}
            raw_docs = body.get("documents")
            if not isinstance(raw_docs, list):
                return {"error": "documents must be a list"}
            documents = [
                Document(
                    id=str(d.get("id", i)),
                    content=str(d.get("content", "")),
                    source=d.get("source"),
                )
                for i, d in enumerate(raw_docs)
            ]
            top_k = body.get("top_k", engine.config.serving.default_top_k)
            rtype = body.get("reranker_type", "auto")
            if batcher is not None:
                result = batcher.rerank_documents(
                    query, documents, top_k=top_k, reranker_type=rtype,
                    priority=self._priority(body),
                )
                engine.metrics.incr("rerank_requests")
                engine.metrics.incr(f"rerank_{result['reranker_used']}")
            else:
                result = engine.rerank(query, documents, top_k=top_k, reranker_type=rtype)
            return rerank_response_dict(result)

        def _priority(self, body: Dict[str, Any]) -> int:
            """Request priority, clamped to the documented -10..10."""
            return max(-10, min(10, int(body.get("priority", 0))))

        def _embedded(self, queries):
            """Text queries embedded on the host; vectors as given."""
            if isinstance(queries, np.ndarray):
                return queries
            return engine.embedder([str(q) for q in queries])

        def _search_result(self, body: Dict[str, Any]):
            """Parse the queries of /search and run them, through the
            batcher when batching.  Returns (SearchResult, None) or
            (None, error dict)."""
            k = int(body.get("k", 10))
            prio = self._priority(body)
            if "vectors" in body:
                queries = np.asarray(body["vectors"], dtype=np.float32)
            elif "queries" in body:
                queries = list(body["queries"])
            elif "query" in body:
                queries = [body["query"]]
            else:
                return None, {"error": "provide query, queries, or vectors"}
            if batcher is not None:
                return batcher.search(self._embedded(queries), k=k, priority=prio), None
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
            k = int(body.get("k", 10))
            candidates = int(body.get("candidates", 100))
            rtype = body.get("reranker_type", "quantum")
            # "auto" routes on the query text, which the batcher's
            # vectors no longer carry
            if batcher is not None and rtype != "auto":
                return batcher.search_rerank(
                    self._embedded(queries), k=k, candidates=candidates,
                    reranker_type=rtype, priority=self._priority(body),
                )
            return engine.search_rerank(
                queries, k=k, candidates=candidates, reranker_type=rtype
            )

        def _handle_add(self, body: Dict[str, Any]) -> Dict[str, Any]:
            texts = body.get("texts")
            if not isinstance(texts, list) or not texts:
                return {"error": "texts must be a non-empty list"}
            ntotal = engine.add_texts([str(t) for t in texts], body.get("metadata"))
            return {"stored_count": len(texts), "total_vectors": ntotal}

    return Handler


def create_server(
    engine: QragEngine,
    host: str = "0.0.0.0",
    port: int = 8000,
    batching: bool = False,
    **batcher_kwargs,
) -> ThreadingHTTPServer:
    """The HTTP server over ``engine``; with ``batching`` its
    ``SearchBatcher`` is ``server.batcher`` (close it after shutdown)."""
    batcher = SearchBatcher(engine, **batcher_kwargs) if batching else None
    server = ThreadingHTTPServer((host, port), _make_handler(engine, batcher))
    server.batcher = batcher
    return server


def serve_in_thread(
    engine: QragEngine,
    host: str = "127.0.0.1",
    port: int = 0,
    batching: bool = False,
    **batcher_kwargs,
) -> ThreadingHTTPServer:
    """``create_server`` serving on a daemon thread (tests, embedding);
    the caller shuts it down (and closes ``server.batcher``)."""
    server = create_server(engine, host, port, batching=batching, **batcher_kwargs)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="qrag_tpu_torch HTTP server")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--index", default=None, help=".faiss file or native dir")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument(
        "--embedding-provider",
        default=None,
        choices=["mock", "hash", "openai", "trained"],
        help="'trained': the bi-encoder, weights from QRAG_EMBEDDING_MODEL",
    )
    parser.add_argument(
        "--topk-mode",
        default=None,
        choices=["exact", "approx", "verified", "refined", "bounded"],
        help="top-k selection mode: 'bounded' = provably-exact "
        "norm-bounded window pruning (ops/bounded_topk.py; also "
        "--sharded); approx/verified/refined select their candidates "
        "with the fused scan + top-k kernel (ops/topk.py)",
    )
    parser.add_argument(
        "--bounded-scan",
        default=None,
        choices=["bf16", "int8"],
        help="with --topk-mode bounded: scan arithmetic — 'int8' scans "
        "exact int32 dots of per-window int8 codes, with margins "
        "covering the quantization residual (still provably exact)",
    )
    parser.add_argument(
        "--bounded-query-dtype",
        default=None,
        choices=["float32", "store"],
        help="with --topk-mode bounded: 'store' rounds queries to the "
        "store dtype first — exact w.r.t. the ROUNDED query; default "
        "float32 = exact w.r.t. the query as given",
    )
    parser.add_argument(
        "--small-batch-accel",
        default=None,
        choices=["none", "clustered", "clustered_probe"],
        help="small-batch latency accelerator: 'clustered' routes query "
        "batches <= IndexConfig.accel_max_batch through the cluster-pruned "
        "PROVABLY-EXACT search (ops/cluster_topk.py), which reads only the "
        "certified groups; 'clustered_probe' = FAISS-IVF nprobe semantics "
        "(no certificates, recall via QRAG_INDEX_CLUSTER_BUDGET), the "
        "explicit approximate opt-in",
    )
    parser.add_argument(
        "--lean-scan",
        action="store_true",
        help="memory-lean serving: int8 windowed packed scan with "
        "gather-free scoring (quantization=int8, quant_scan=window, "
        "exact_scores=False) — the (B, N) score matrix never exists "
        "and candidate rows are never gathered; returned scores are "
        "approximate (block-int8, ~1%%)",
    )
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument(
        "--reload",
        action="store_true",
        help="dev auto-reload: re-exec on a source change of the package",
    )
    parser.add_argument(
        "--batching",
        action="store_true",
        help="coalesce concurrent requests into device batches",
    )
    parser.add_argument(
        "--sharded",
        action="store_true",
        help="shard corpus rows over the mesh's slots (mesh from QRAG_MESH_* "
        "env / config; parallel/sharded_index.py)",
    )
    parser.add_argument(
        "--shard-merge",
        default=None,
        choices=["allgather", "ring"],
        help="per-shard top-k merge strategy (with --sharded)",
    )
    parser.add_argument(
        "--elastic",
        action="store_true",
        help="with --sharded: survive the loss of slots by re-sharding over "
        "the rest (parallel/elastic.py)",
    )
    return parser


def _configure(parser: argparse.ArgumentParser, args) -> QragConfig:
    """The config the flags select (env overrides first), after the
    reference's argument checks; each index choice is also written to
    the env channel, which engine bundles re-read (``QragEngine.load``)."""
    config = QragConfig().with_env_overrides()
    if (args.shard_merge or args.elastic) and not args.sharded:
        parser.error("--shard-merge/--elastic require --sharded")
    if args.lean_scan and args.sharded:
        parser.error("--lean-scan is a single-device index mode")
    if args.bounded_scan == "int8" and args.sharded:
        # the sharded bounded path scans bf16: accepting the flag would
        # serve bf16 while the operator believes int8 is active
        parser.error(
            "--bounded-scan int8 is not implemented for --sharded "
            "(the sharded bounded path scans bf16); drop one flag"
        )
    if args.topk_mode and args.lean_scan:
        parser.error("--lean-scan fixes its own scan mode")
    topk_mode = args.topk_mode or config.index.topk_mode
    if args.bounded_scan and topk_mode != "bounded":
        parser.error("--bounded-scan requires --topk-mode bounded")
    if args.bounded_query_dtype and topk_mode != "bounded":
        parser.error("--bounded-query-dtype requires --topk-mode bounded")
    index_over = {
        "topk_mode": args.topk_mode,
        "bounded_scan": args.bounded_scan,
        "bounded_query_dtype": args.bounded_query_dtype,
        "small_batch_accel": args.small_batch_accel,
    }
    if args.lean_scan:
        index_over.update(quantization="int8", quant_scan="window", exact_scores=False)
    if args.sharded:
        index_over.update(
            sharded=True, shard_merge=args.shard_merge or config.index.shard_merge
        )
        if args.elastic or config.index.elastic:
            index_over["elastic"] = True
    for name, value in index_over.items():
        if value is None:
            continue
        config = replace(config, index=replace(config.index, **{name: value}))
        env = {False: "0", True: "1"}.get(value, str(value))
        os.environ[f"QRAG_INDEX_{name.upper()}"] = env
    if args.embedding_provider:
        config = replace(
            config,
            embedding=replace(config.embedding, provider=args.embedding_provider),
        )
    return config


def main(argv=None) -> None:
    parser = _parser()
    args = parser.parse_args(argv)
    config = _configure(parser, args)
    configure_logging()
    host = args.host or config.serving.host
    port = args.port if args.port is not None else config.serving.port

    if args.index and os.path.isdir(args.index):
        if os.path.exists(os.path.join(args.index, "engine.json")):
            engine = QragEngine.load(args.index, device=args.device)
            if args.embedding_provider:
                engine.embedder = get_embedder(
                    replace(engine.config.embedding, provider=args.embedding_provider),
                    engine.device,
                )
        else:
            cls_, kw = _index_cls_and_kwargs(config)
            kw.pop("row_pad_multiple", None)
            index = cls_.load_native(args.index, device=args.device, **kw)
            engine = QragEngine(config=config, index=index)
    elif args.index:
        engine = QragEngine.from_faiss(args.index, config=config, device=args.device)
    else:
        engine = QragEngine(config=config, device=args.device)

    # bind before warmup so clients can connect immediately; the
    # coalesced pair axis stays within the configured doc buckets
    server = create_server(
        engine, host, port, batching=args.batching,
        **({"max_pairs": max(config.serving.doc_buckets)} if args.batching else {}),
    )
    if args.reload:
        from qrag_tpu_torch.serving.devreload import start_reloader

        start_reloader()
    if not args.no_warmup:
        threading.Thread(target=engine.warmup, daemon=True).start()
    logger.info("serving on %s:%d (index ntotal=%d)", host, port, engine.index.ntotal)
    server.serve_forever()


if __name__ == "__main__":
    main()
