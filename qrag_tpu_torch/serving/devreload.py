"""Dev auto-reload for the serving CLIs (``--reload``; the port's
counterpart of ``qrag_tpu.serving.devreload``, watching the port's
sources).

The reference exposes uvicorn's ``--reload`` on its MCP server CLI
(``mcp/server/server.py:56-62``); the stdlib servers here get the
equivalent: a watcher thread polls the package's source mtimes and
re-execs the process (same argv) when anything changes.  Dev-only —
state (index appends since the last save, caches) does not survive the
re-exec, exactly like uvicorn's reloader.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, Iterable, Optional

logger = logging.getLogger(__name__)


def _source_mtimes(roots: Iterable[str]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for root in roots:
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    p = os.path.join(dirpath, f)
                    try:
                        out[p] = os.stat(p).st_mtime
                    except OSError:
                        pass
    return out


def start_reloader(
    extra_roots: Optional[Iterable[str]] = None,
    poll_s: float = 0.7,
) -> threading.Thread:
    """Watch the qrag_tpu_torch package (plus `extra_roots`) and re-exec
    on any .py change.  Returns the (daemon) watcher thread."""
    import qrag_tpu_torch

    roots = [os.path.dirname(qrag_tpu_torch.__file__)]
    if extra_roots:
        roots.extend(extra_roots)
    baseline = _source_mtimes(roots)

    def watch() -> None:
        while True:
            time.sleep(poll_s)
            current = _source_mtimes(roots)
            if current != baseline:
                changed = [
                    p
                    for p in set(baseline) | set(current)
                    if baseline.get(p) != current.get(p)
                ]
                logger.warning(
                    "source changed (%s) — reloading",
                    ", ".join(os.path.basename(p) for p in changed[:3]),
                )
                sys.stdout.flush()
                sys.stderr.flush()
                os.execv(sys.executable, [sys.executable] + sys.argv)

    t = threading.Thread(target=watch, daemon=True, name="qrag-reloader")
    t.start()
    logger.info("dev reloader watching %s", roots)
    return t
