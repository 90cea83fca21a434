"""LLM-driven MCP orchestrator (the port's own copy of
``qrag_tpu.serving.llm_orchestrator``; gated on the optional ``openai``
package — absent in this image; the rule-based orchestrator is the
offline default).

Reimplements the reference's agent loop (``mcp/client/main.py:70-258``)
on the plain OpenAI chat API with JSON tool selection instead of
atomic-agents/instructor: the model sees the tool schemas, emits
``{"reasoning", "action": {"tool", "arguments"}}`` or
``{"final_response": ...}``, and tool results (including structured
errors with ``available_shows``) are fed back for error-driven retry.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

SYSTEM_PROMPT = """You are an orchestrator for podcast transcript tools.
You see a user request and the available tools (JSON schemas below).
Respond ONLY with JSON, either:
  {"reasoning": "...", "action": {"tool": "<name>", "arguments": {...}}}
to call a tool, or:
  {"reasoning": "...", "final_response": "..."}
to answer the user. If a tool errors with available_shows, retry with
the closest matching show name.

Tools:
{tools}
"""


def _get_api_key(ssm_param: str = "/openai/api_key") -> str:
    key = os.environ.get("OPENAI_API_KEY")
    if key:
        return key
    import boto3  # type: ignore

    return boto3.client("ssm").get_parameter(
        Name=ssm_param, WithDecryption=True
    )["Parameter"]["Value"]


class OpenAIOrchestrator:
    def __init__(
        self,
        client,
        model: str = "gpt-4o",
        index_path: str = "qrag_index.faiss",
        max_steps: int = 8,
    ):
        from openai import OpenAI  # type: ignore

        self.mcp = client
        self.llm = OpenAI(api_key=_get_api_key())
        self.model = model
        self.max_steps = max_steps
        tools = json.dumps(self.mcp.list_tools(), indent=1)
        self.system = SYSTEM_PROMPT.replace("{tools}", tools)

    def _ask(self, messages) -> Dict[str, Any]:
        resp = self.llm.chat.completions.create(
            model=self.model,
            messages=messages,
            response_format={"type": "json_object"},
        )
        return json.loads(resp.choices[0].message.content)

    def run(self, query: str) -> str:
        messages = [
            {"role": "system", "content": self.system},
            {"role": "user", "content": query},
        ]
        for _ in range(self.max_steps):
            decision = self._ask(messages)
            if "final_response" in decision:
                return str(decision["final_response"])
            action = decision.get("action") or {}
            name = action.get("tool")
            arguments = action.get("arguments") or {}
            if not name:
                return f"orchestrator returned no action: {decision}"
            ok, payload = self.mcp.call_tool(name, arguments)
            feedback = {
                "tool": name,
                "success": ok,
                "result": payload,
            }
            messages.append(
                {"role": "assistant", "content": json.dumps(decision)}
            )
            messages.append(
                {"role": "user", "content": f"TOOL RESULT: {json.dumps(feedback)}"}
            )
        return "orchestrator exceeded max steps"
