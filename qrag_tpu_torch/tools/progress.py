"""Tool progress channel, contextvar-scoped (the port's own copy of
``qrag_tpu.tools.progress``).

The reference serves FastMCP's *streamable HTTP* transport
(``mcp/server/server.py:34-51``), whose tools/call responses can carry
``notifications/progress`` events before the result.  This module is
the transport-agnostic half: tools call :func:`report_progress` at
stage boundaries; whoever invoked the tool (the SSE handler in
``qrag_tpu_torch/serving/mcp_server.py``, a CLI, a test) installs a callback with
:func:`progress_scope`.  No callback installed → zero overhead no-ops.

contextvars propagate into ``asyncio.run`` (it copies the current
context), so the sync dispatch path in ``ToolService`` needs no extra
plumbing.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional

ProgressCallback = Callable[[float, Optional[float], Optional[str]], None]

_progress_cb: contextvars.ContextVar[Optional[ProgressCallback]] = (
    contextvars.ContextVar("qrag_tool_progress", default=None)
)


def report_progress(
    progress: float,
    total: Optional[float] = None,
    message: Optional[str] = None,
) -> None:
    """Emit a progress tick from inside a tool.  No-op unless a scope
    is active (so tools never pay for unconsumed progress)."""
    cb = _progress_cb.get()
    if cb is not None:
        cb(float(progress), total, message)


def current_callback() -> Optional[ProgressCallback]:
    """The active sink, if any — lets composite tools rescale nested
    tools' progress into their own range (keeping the stream's
    progress monotone, as the MCP spec asks)."""
    return _progress_cb.get()


@contextlib.contextmanager
def progress_scope(callback: ProgressCallback) -> Iterator[None]:
    """Install `callback` as the progress sink for this context."""
    token = _progress_cb.set(callback)
    try:
        yield
    finally:
        _progress_cb.reset(token)


@contextlib.contextmanager
def nested_progress(base: float, span: float, total: float) -> Iterator[None]:
    """Rescale nested report_progress(p, t, m) calls into
    [base, base+span] of an outer `total`-scale progress."""
    outer = _progress_cb.get()
    if outer is None:
        yield
        return

    def rescaled(p: float, t: Optional[float], m: Optional[str]) -> None:
        frac = (p / t) if t else 0.0
        outer(base + span * min(max(frac, 0.0), 1.0), total, m)

    token = _progress_cb.set(rescaled)
    try:
        yield
    finally:
        _progress_cb.reset(token)
