#!/usr/bin/env python
"""Sharded + elastic serving and streaming MCP ingestion on the
PyTorch/CUDA port (the counterpart of
``examples/sharded_streaming_demo.py``):

  1. build a corpus and serve it ROW-SHARDED with elastic recovery
     (the ``qrag-serve-torch --sharded --elastic`` path);
  2. inject a transient failure (retried, every shard kept), then a
     persistent one on one slot, and watch it re-shard;
  3. run an MCP ingestion over the STREAMING transport with live
     progress notifications.

The reference runs its mesh over 8 virtual CPU devices.  Here the mesh
is 1 x 4 slots (``parallel.mesh.Slot``) on ONE device, as the port's
single-card runs use it: four shards of the corpus on one card (or the
CPU), each searched on its own and merged, so the re-shard is real but
it is not a multi-card scale-out.

Usage: python examples/sharded_streaming_demo_torch.py [--device cuda|cpu]
(the device defaults to CUDA and raises without it)
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qrag_tpu_torch.config import QragConfig  # noqa: E402
from qrag_tpu_torch.device import resolve_device  # noqa: E402
from qrag_tpu_torch.engine import QragEngine  # noqa: E402

SLOTS = 4


def sharded_elastic_demo(device) -> None:
    print(f"== sharded + elastic serving over {SLOTS} slots on {device}")
    cfg = QragConfig.from_dict(
        {
            "embedding": {"provider": "hash", "dim": 64},
            "index": {"sharded": True, "elastic": True, "metric": "l2"},
            "mesh": {"data_parallel": 1, "model_parallel": SLOTS},
        }
    )
    eng = QragEngine(config=cfg, device=device)
    texts = [f"episode {i} discusses topic {i % 7}" for i in range(200)]
    eng.add_texts(texts, metadata=[f"Show/ep{i}" for i in range(200)])
    print("   layout:", json.dumps(eng.index.layout()))

    out = eng.search_rerank("find topic 3 discussions", k=3, candidates=20)
    print("   top hit:", out["results"][0][0]["metadata"])

    def boom():
        raise RuntimeError("injected device loss")

    eng.index.inject_search_failure(boom)
    out1 = eng.search_rerank("find topic 3 discussions", k=3, candidates=20)
    print(
        f"   survived a transient failure: rebuilds={eng.index.rebuilds}, "
        f"still {eng.index.layout()['mesh']['model']} shards, "
        f"same top hit: {out1['results'][0][0]['metadata']}"
    )
    eng.index.inject_device_failure(eng.index.devices[1])
    out2 = eng.search_rerank("find topic 3 discussions", k=3, candidates=20)
    print(
        f"   survived a device loss: rebuilds={eng.index.rebuilds}, "
        f"now {eng.index.layout()['mesh']['model']} shards, "
        f"same top hit: {out2['results'][0][0]['metadata']}"
    )


def streaming_mcp_demo(device) -> None:
    print("== streaming MCP ingestion (SSE progress)")
    from qrag_tpu_torch.config import EmbeddingConfig
    from qrag_tpu_torch.pipeline.storage import LocalTranscriptStore
    from qrag_tpu_torch.serving.mcp_client import McpClient
    from qrag_tpu_torch.serving.mcp_server import create_tool_service, serve_in_thread

    root = tempfile.mkdtemp()
    d = os.path.join(root, "Demo_Show", "2026")
    os.makedirs(d)
    for ep in ("alpha", "beta", "gamma"):
        with open(os.path.join(d, f"{ep}_transcript.json"), "w") as f:
            json.dump({"transcript": f"the {ep} episode content " * 12}, f)
    service = create_tool_service(
        store=LocalTranscriptStore(root),
        config=EmbeddingConfig(provider="hash", dim=32),
        device=device,
    )
    server = serve_in_thread(service)
    url = f"http://127.0.0.1:{server.server_address[1]}/mcp"

    events = []
    client = McpClient(
        url,
        stream=True,
        on_progress=lambda p, t, m: events.append(f"{p:.1f}/{t} {m}"),
    )
    client.initialize()
    ok, payload = client.call_tool(
        "ProcessTranscriptsToEmbeddings",
        {"show_name": "Demo_Show", "index_path": os.path.join(root, "i.faiss")},
    )
    server.shutdown()
    server.server_close()
    print(f"   ingested: {payload.get('embeddings_created')} embeddings, "
          f"{len(events)} progress events streamed:")
    for e in events:
        print("    ", e)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(parser.parse_args(argv).device)
    sharded_elastic_demo(device)
    streaming_mcp_demo(device)
    print("demo complete")


if __name__ == "__main__":
    main()
