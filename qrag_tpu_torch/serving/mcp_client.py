"""MCP agent client — tool discovery + orchestrated tool calls + REPL
(the port's own copy of ``qrag_tpu.serving.mcp_client``; stdlib only).

The reference's client (``mcp/client/main.py:46-258``) fetches the MCP
tool list, shows it in a rich table, and loops a GPT-4o orchestrator
(atomic-agents + instructor) whose action schema is the union of tool
inputs, feeding tool results (or structured errors with
``available_shows``) back until a final response.

This client keeps that architecture with two orchestrators:

  * `RuleBasedOrchestrator` (default, offline) — deterministic intent
    parsing with the same error-driven retry loop: unknown-show errors
    are retried with the closest ``available_shows`` match.
  * `OpenAIOrchestrator` — the reference's LLM loop, gated on the
    optional ``openai`` package (absent in this image).

Transport is JSON-RPC 2.0 over HTTP via stdlib urllib (initialize →
tools/list → tools/call), against ``qrag_tpu_torch.serving.mcp_server``.
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import urllib.request
from typing import Any, Dict, List, Optional, Tuple


class McpClient:
    """MCP streamable-HTTP client (stdlib).

    Speaks the same transport as the reference's HTTP-stream client
    (``mcp/client/main.py:54``): requests advertise
    ``Accept: application/json, text/event-stream``; when the server
    streams, SSE ``notifications/progress`` events are surfaced through
    ``on_progress`` and the final ``message`` event is the response.
    Plain-JSON servers keep working unchanged.
    """

    def __init__(
        self,
        url: str = "http://127.0.0.1:6969/mcp",
        stream: bool = True,
        on_progress=None,
    ):
        self.url = url
        self.stream = stream
        self.on_progress = on_progress  # fn(progress, total, message)
        self.session_id: Optional[str] = None
        self._id = 0

    def _rpc(self, method: str, params: Optional[Dict[str, Any]] = None):
        self._id += 1
        payload = {
            "jsonrpc": "2.0",
            "id": self._id,
            "method": method,
            "params": params or {},
        }
        if self.stream and method == "tools/call":
            payload["params"].setdefault("_meta", {})[
                "progressToken"
            ] = self._id
        headers = {"Content-Type": "application/json"}
        if self.stream:
            headers["Accept"] = "application/json, text/event-stream"
        if self.session_id:
            headers["Mcp-Session-Id"] = self.session_id
        req = urllib.request.Request(
            self.url,
            data=json.dumps(payload).encode(),
            headers=headers,
            method="POST",
        )
        with urllib.request.urlopen(req) as resp:
            sid = resp.headers.get("Mcp-Session-Id")
            if sid:
                self.session_id = sid
            ctype = resp.headers.get("Content-Type", "")
            if "text/event-stream" in ctype:
                body = self._consume_sse(resp)
            else:
                body = json.loads(resp.read())
        if body is None:
            raise RuntimeError("stream ended without a response")
        if "error" in body:
            raise RuntimeError(f"rpc error: {body['error']}")
        return body["result"]

    def _consume_sse(self, resp) -> Optional[Dict[str, Any]]:
        """Read SSE events; forward progress notifications; return the
        final JSON-RPC response (the event carrying our request id)."""
        final = None
        data_lines: List[str] = []
        for raw in resp:  # http.client un-chunks transparently
            line = raw.decode("utf-8").rstrip("\r\n")
            if line.startswith("data:"):
                data_lines.append(line[len("data:"):].strip())
                continue
            if line:  # event:/id:/retry: fields — no dispatch needed
                continue
            if not data_lines:  # blank line, empty event
                continue
            msg = json.loads("\n".join(data_lines))
            data_lines = []
            if msg.get("method") == "notifications/progress":
                if self.on_progress is not None:
                    p = msg.get("params") or {}
                    self.on_progress(
                        p.get("progress"), p.get("total"), p.get("message")
                    )
            elif "id" in msg:
                final = msg
        return final

    def initialize(self) -> Dict[str, Any]:
        return self._rpc("initialize")

    def list_tools(self) -> List[Dict[str, Any]]:
        return self._rpc("tools/list")["tools"]

    def call_tool(
        self, name: str, arguments: Dict[str, Any]
    ) -> Tuple[bool, Dict[str, Any]]:
        """Returns (success, first JSON payload or {'text': ...})."""
        result = self._rpc(
            "tools/call", {"name": name, "arguments": arguments}
        )
        payload: Dict[str, Any] = {}
        for block in result.get("content", []):
            if block.get("type") != "text":
                continue
            text = block.get("text", "")
            if text.startswith("error: "):
                payload.setdefault("error", text[len("error: "):])
                continue
            try:
                data = json.loads(text)
                if isinstance(data, dict):
                    payload.update(data)
                    continue
            except (ValueError, TypeError):
                pass
            payload.setdefault("text", text)
        return not result.get("isError", False), payload


class RuleBasedOrchestrator:
    """Deterministic intent → tool-call planner with error-feedback
    retry (the agent loop of ``mcp/client/main.py:133-258``, minus the
    LLM)."""

    def __init__(self, client: McpClient, index_path: str = "qrag_index.faiss"):
        self.client = client
        self.default_index_path = index_path

    def run(self, query: str, max_steps: int = 4) -> str:
        q = query.strip()
        ql = q.lower()
        if re.search(r"\b(list|show me|what|which|available)\b.*\bshows?\b", ql) or ql in (
            "shows",
            "list shows",
        ):
            ok, payload = self.client.call_tool("ReadFromS3", {})
            shows = payload.get("available_shows", [])
            return (
                "Available shows: " + ", ".join(shows)
                if shows
                else "No shows found."
            )

        # match against the ORIGINAL string (case-insensitive) so the
        # captured show name and index path keep their casing
        m = re.search(
            r"\b(?:index|process|ingest|embed)\b\s+(?:show\s+)?([\w\- ]+?)"
            r"(?:\s+(?:into|to)\s+(\S+))?$",
            q,
            re.IGNORECASE,
        )
        if m:
            show = m.group(1).strip()
            index_path = m.group(2) or self.default_index_path
            return self._process_show(show, index_path, max_steps)

        m = re.search(
            r"\b(?:search|find)\b\s+(?:for\s+)?(.+?)(?:\s+in\s+(\S+))?$",
            q,
            re.IGNORECASE,
        )
        if m:
            query_text = m.group(1).strip().strip("'\"")
            index_path = m.group(2) or self.default_index_path
            ok, payload = self.client.call_tool(
                "SearchIndex",
                {"index_path": index_path, "query": query_text, "k": 5},
            )
            if not ok:
                return f"Search failed: {payload.get('error', 'unknown')}"
            hits = payload.get("hits", [])
            if not hits:
                return "No results."
            lines = [
                f"  {h.get('metadata') or h.get('index')} (score {h.get('score'):.4f})"
                for h in hits
            ]
            return f"Top {len(hits)} for {query_text!r}:\n" + "\n".join(lines)

        return (
            "I can 'list shows', 'index <show> [into <path>]', or "
            f"'search <query> [in <path>]'. (got: {q!r})"
        )

    def _process_show(self, show: str, index_path: str, max_steps: int) -> str:
        attempt_show = show
        last_error = ""
        for _ in range(max_steps):
            ok, payload = self.client.call_tool(
                "ProcessTranscriptsToEmbeddings",
                {"show_name": attempt_show, "index_path": index_path},
            )
            if ok:
                return (
                    f"Indexed show {payload.get('show_name')!r}: "
                    f"{payload.get('embeddings_created')} embeddings from "
                    f"{payload.get('transcripts_processed')} transcripts "
                    f"(index now {payload.get('total_vectors')} vectors at "
                    f"{payload.get('index_path')})."
                )
            # error-driven retry using available_shows (main.py:194-217)
            last_error = payload.get("error", "unknown error")
            shows = payload.get("available_shows") or []
            match = difflib.get_close_matches(
                attempt_show, shows, n=1, cutoff=0.4
            )
            lower_match = next(
                (s for s in shows if s.lower() == attempt_show.lower()), None
            )
            next_show = lower_match or (match[0] if match else None)
            if next_show is None or next_show == attempt_show:
                avail = f" Available: {', '.join(shows)}." if shows else ""
                return f"Failed: {last_error}.{avail}"
            attempt_show = next_show
        return f"Failed after retries: {last_error}"


def make_orchestrator(client: McpClient, kind: str = "auto", **kwargs):
    if kind in ("auto", "openai"):
        try:  # pragma: no cover - needs openai
            import openai  # type: ignore  # noqa: F401

            from qrag_tpu_torch.serving.llm_orchestrator import OpenAIOrchestrator

            return OpenAIOrchestrator(client, **kwargs)
        except ImportError:
            if kind == "openai":
                raise RuntimeError(
                    "openai package not installed; use --orchestrator rules"
                )
    return RuleBasedOrchestrator(client, **kwargs)


def render_tool_table(tools: List[Dict[str, Any]], width: int = 100) -> str:
    """Box-drawn tool table (the reference renders a rich.Table of
    discovered tools, ``mcp/client/main.py:60-67``; stdlib here)."""
    name_w = max([len(t["name"]) for t in tools] + [4])
    desc_w = max(20, width - name_w - 7)
    top = f"┌─{'─' * name_w}─┬─{'─' * desc_w}─┐"
    mid = f"├─{'─' * name_w}─┼─{'─' * desc_w}─┤"
    bot = f"└─{'─' * name_w}─┴─{'─' * desc_w}─┘"
    rows = [top, f"│ {'Tool':<{name_w}} │ {'Description':<{desc_w}} │", mid]
    for t in tools:
        desc = " ".join(str(t.get("description", "")).split())
        first = True
        while desc or first:
            line, desc = desc[:desc_w], desc[desc_w:]
            rows.append(
                f"│ {(t['name'] if first else ''):<{name_w}} │ {line:<{desc_w}} │"
            )
            first = False
    rows.append(bot)
    return "\n".join(rows)


def _progress_printer(progress, total, message):
    """Stream tool progress to the terminal as it arrives (the
    reference streams agent turns live, ``main.py:163``)."""
    if total:
        bar_n = int(20 * min(progress / total, 1.0))
        bar = "█" * bar_n + "░" * (20 - bar_n)
        pct = f"{100 * progress / total:3.0f}%"
    else:
        bar, pct = "░" * 20, " ..."
    msg = f" {message}" if message else ""
    print(f"\r  [{bar}] {pct}{msg:<50.50s}", end="", flush=True)


def main(argv=None) -> None:  # pragma: no cover - interactive
    parser = argparse.ArgumentParser(description="qrag_tpu_torch MCP client")
    parser.add_argument("--url", default="http://127.0.0.1:6969/mcp")
    parser.add_argument(
        "--orchestrator", default="auto", choices=["auto", "rules", "openai"]
    )
    parser.add_argument(
        "--no-stream", action="store_true", help="plain JSON transport"
    )
    args = parser.parse_args(argv)

    client = McpClient(
        args.url,
        stream=not args.no_stream,
        on_progress=None if args.no_stream else _progress_printer,
    )
    info = client.initialize()
    tools = client.list_tools()
    name = info["serverInfo"]["name"]
    transport = "streamable-http" if client.stream else "json"
    print(f"connected to {name} ({transport}, session "
          f"{(client.session_id or 'n/a')[:8]}) — {len(tools)} tools:")
    print(render_tool_table(tools))
    orchestrator = make_orchestrator(client, args.orchestrator)
    print("type a request ('list shows', 'index <show>', 'search <q>'), or 'quit'")
    while True:
        try:
            query = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if query.lower() in ("quit", "exit", "q"):
            break
        if not query:
            continue
        answer = orchestrator.run(query)
        print()  # end the progress line
        print(answer)


if __name__ == "__main__":
    main()
