"""Tool registry + dispatcher (the port's counterpart of
``qrag_tpu.tools.service``).

Counterpart of the reference's ``ToolService``
(``mcp/server/services/tool_service.py:12-87``): a name→tool registry
whose ``execute_tool`` validates inputs through each tool's input
model.  The reference generated MCP handler *source code strings* per
tool and ``exec()``'d them (``tool_service.py:89-127``); that quirk is
deliberately dropped (SURVEY.md Appendix A.8) — handlers here are
plain closures with explicit schemas.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Dict, List, Optional

from qrag_tpu_torch.tools.interface import Tool, ToolResponse, ValidationError

logger = logging.getLogger(__name__)


class ToolService:
    def __init__(self):
        self._tools: Dict[str, Tool] = {}

    def register_tool(self, tool: Tool) -> None:
        if tool.name in self._tools:
            raise ValueError(f"duplicate tool name {tool.name!r}")
        self._tools[tool.name] = tool

    def register_tools(self, tools: List[Tool]) -> None:
        for t in tools:
            self.register_tool(t)

    @property
    def tools(self) -> List[Tool]:
        return list(self._tools.values())

    def get_tool(self, name: str) -> Optional[Tool]:
        return self._tools.get(name)

    def list_schemas(self) -> List[Dict[str, Any]]:
        return [t.get_schema() for t in self.tools]

    async def execute_tool(
        self, name: str, arguments: Dict[str, Any]
    ) -> ToolResponse:
        tool = self._tools.get(name)
        if tool is None:
            return ToolResponse.from_error(
                f"unknown tool {name!r}",
                available_tools=[t.name for t in self.tools],
            )
        try:
            input_data = tool.input_model(**(arguments or {}))
        except ValidationError as e:
            return ToolResponse.from_error(f"invalid input: {e}")
        try:
            return await tool.execute(input_data)
        except Exception as e:  # noqa: BLE001 - tool fault isolation
            logger.exception("tool %s failed", name)
            return ToolResponse.from_error(f"tool execution failed: {e}")

    def execute_tool_sync(
        self, name: str, arguments: Dict[str, Any]
    ) -> ToolResponse:
        return asyncio.run(self.execute_tool(name, arguments))

    def make_handler(self, name: str) -> Callable:
        """A plain async closure per tool (no exec-generated source)."""
        async def handler(arguments: Dict[str, Any]) -> ToolResponse:
            return await self.execute_tool(name, arguments)

        handler.__name__ = f"handle_{name}"
        return handler
