"""Tracing / profiling utilities (PyTorch port of
``qrag_tpu.utils.profiling``).

  * ``trace(log_dir)`` — context manager around ``torch.profiler``
    (CPU and, where there is one, CUDA activity) that writes a Chrome
    trace (``trace.json``, viewable in Perfetto or chrome://tracing)
    into ``log_dir``;
  * ``annotate(name)`` — a named span on that timeline
    (``torch.profiler.record_function``), so engine stages (scan,
    rerank, merge) show as ranges;
  * ``stage_timer(name)`` — wall-clock span recorded into
    ``GLOBAL_METRICS`` (it shows on the /stats endpoint);
  * ``device_memory_stats()`` — ``torch.cuda.memory_stats`` of the
    current card, or None without one.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch

from qrag_tpu_torch.utils.metrics import GLOBAL_METRICS

logger = logging.getLogger(__name__)

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace to ``log_dir/trace.json``; yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span on the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def stage_timer(name: str) -> Iterator[None]:
    """Wall-clock stage span recorded into the metrics store."""
    with GLOBAL_METRICS.timer(name):
        yield


def device_memory_stats() -> Optional[dict]:
    """Memory stats of the current CUDA device, or None without one."""
    if not torch.cuda.is_available():
        return None
    return dict(torch.cuda.memory_stats())
