"""Metrics & counters surfaced on the /stats endpoint (the port's own
copy of ``qrag_tpu.utils.metrics``).

The reference had per-module wall-clock logging but no metrics store
(SURVEY.md §5 observability); this adds thread-safe counters and
latency histograms with the same logging shape.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict, List


class Metrics:
    """Process-wide thread-safe counters + latency records."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._latencies: Dict[str, List[float]] = defaultdict(list)
        self._started = time.time()

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            lat = self._latencies[name]
            lat.append(seconds)
            if len(lat) > 10_000:  # bound memory
                del lat[: len(lat) // 2]

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "uptime_s": round(time.time() - self._started, 3),
                "counters": dict(self._counters),
                "latency": {},
            }
            for name, lat in self._latencies.items():
                if not lat:
                    continue
                s = sorted(lat)
                n = len(s)
                out["latency"][name] = {
                    "count": n,
                    "mean_ms": round(1e3 * sum(s) / n, 3),
                    "p50_ms": round(1e3 * s[n // 2], 3),
                    "p99_ms": round(1e3 * s[min(n - 1, int(n * 0.99))], 3),
                }
            return out


class _Timer:
    def __init__(self, metrics: Metrics, name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.metrics.observe(self.name, time.time() - self._t0)
        return False


GLOBAL_METRICS = Metrics()
