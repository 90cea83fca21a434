"""The traced run: ``torch.profiler`` over a cell's traffic, read beside
host spans that the benchmark records around calls into the program's
layers (nothing inside the program changes).

It reports device busy time and idle share, device ms by kernel group,
by kernel and by the layer whose span was open at the launch, host ms
per layer, and idle device time (and the longest idle gaps) by what the
host was doing: the innermost layer span open, and the CUDA runtime
call in progress if one was.  ``torch.profiler`` records operators only
on the thread that starts it, so the layers are timed by the
benchmark's own spans, on every thread; CUPTI's kernels and runtime
calls are seen from all threads.  The reading works on plain spans, so
the CPU tests hold it to hand-made timelines."""

from __future__ import annotations

import contextlib
import functools
import heapq
import time
from typing import NamedTuple

import numpy as np

# kernel name fragment -> group, first match wins
KERNEL_GROUPS = (
    ("packed_window_scan_wide", "K1 wide arm"),
    ("packed_window_scan_kernel", "K1 general arm"),
    ("sort", "sorts"),
    ("gemm", "f32 products"),
    ("xmma", "f32 products"),
    ("gemv", "f32 products"),
    ("memcpy htod", "copies host to device"),
    ("memcpy dtoh", "copies device to host"),
    ("memcpy", "copies on the device"),
    ("memset", "memsets"),
)
OUTSIDE = "outside the labelled layers"
PYTHON = "Python"
MARK = "bench_cells.clock_mark"


def kernel_group(name: str) -> str:
    low = name.lower()
    for frag, group in KERNEL_GROUPS:
        if frag in low:
            return group
    return "elementwise and reductions"


class Span(NamedTuple):
    start: float  # us on the profiler's clock
    end: float
    name: str


class DeviceSpan(NamedTuple):
    start: float
    end: float
    name: str
    launched: float  # when the host launched it (its runtime call), else its start


_MISSING = object()


@contextlib.contextmanager
def layer_spans(targets, out: list):
    """Wraps each ``(owner, attribute, label)`` callable (a module's
    function or an object's method) for the block so that every call,
    on any thread, appends ``(label, start_ns, end_ns)`` of
    ``time.perf_counter_ns`` to ``out``; puts each back after."""
    saved = []
    for owner, attr, label in targets:
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*a, _fn=fn, _label=label, **kw):
            t0 = time.perf_counter_ns()
            try:
                return _fn(*a, **kw)
            finally:
                out.append((_label, t0, time.perf_counter_ns()))

        saved.append((owner, attr, vars(owner).get(attr, _MISSING)))
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, old in reversed(saved):
            if old is _MISSING:
                delattr(owner, attr)  # an instance attribute over a method
            else:
                setattr(owner, attr, old)


def innermost(spans, times) -> list:
    """For each of ``times``, the shortest of ``spans`` that covers it,
    or None.  One sweep over the spans sorted by start."""
    spans = sorted(spans, key=lambda s: s.start)
    order = sorted(range(len(times)), key=lambda i: times[i])
    out, live, j = [None] * len(times), [], 0  # live: heap of (end, position)
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j].start <= t:
            heapq.heappush(live, (spans[j].end, j))
            j += 1
        while live and live[0][0] < t:
            heapq.heappop(live)
        if live:
            out[i] = min((spans[k] for _, k in live), key=lambda s: s.end - s.start)
    return out


def _union(spans):
    merged = []
    for s, e in sorted((s.start, s.end) for s in spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _top(table, n=10):
    return dict(sorted(table.items(), key=lambda kv: -kv[1])[:n])


def summarize(dev, runtime, layers, wall_ms: float, calls: int, gaps: int = 5) -> dict:
    """The breakdown per call: host ms per layer (inclusive of the layers
    it calls); device busy ms (the union of ``dev``), idle share of
    ``wall_ms``, device ms by kernel group, by kernel (the top ten) and
    by the innermost layer span open at each launch; idle ms between
    device spans by host activity, and the ``gaps`` longest idle gaps.
    Also each layer call's median ms.  ``runtime`` are the CUDA runtime
    calls, ``layers`` the layer spans; all on one clock, in us."""
    spells = {}
    for s in layers:
        spells.setdefault(s.name, []).append((s.end - s.start) / 1e3)
    out = {"wall_ms_per_call": wall_ms / calls,
           "host_ms_by_layer": _top({k: sum(v) / calls for k, v in spells.items()}),
           "host_call_p50_ms_by_layer": {k: float(np.median(v)) for k, v in spells.items()}}
    if not dev:
        return {"device": "not measured (the profiler saw no device time)", **out}
    busy = _union(dev)
    busy_ms = sum(e - s for s, e in busy) / 1e3
    by_group, by_name, by_layer = {}, {}, {}
    for s, owner in zip(dev, innermost(layers, [s.launched for s in dev])):
        ms = (s.end - s.start) / 1e3 / calls
        for table, key in ((by_group, kernel_group(s.name)), (by_name, s.name[:80]),
                           (by_layer, owner.name if owner else OUTSIDE)):
            table[key] = table.get(key, 0.0) + ms
    holes = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    mids = [(s + e) / 2 for s, e in holes]
    what = [f"{lay.name if lay else OUTSIDE} > {call.name if call else PYTHON}"
            for lay, call in zip(innermost(layers, mids), innermost(runtime, mids))]
    idle_by = {}
    for (s, e), w in zip(holes, what):
        idle_by[w] = idle_by.get(w, 0.0) + (e - s) / 1e3 / calls
    longest = sorted(zip(holes, what), key=lambda h: h[0][0] - h[0][1])[:gaps]
    return {
        **out,
        "device_busy_ms_per_call": busy_ms / calls,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_by_group": _top(by_group),
        "device_ms_by_kernel": _top(by_name),
        "device_ms_by_launching_layer": _top(by_layer),
        "idle_ms_by_host_activity": _top(idle_by, 8),
        "longest_idle_gaps": [{"ms": (e - s) / 1e3, "host": w} for (s, e), w in longest],
    }


def spans_of(events, mark_ns: int) -> tuple:
    """(device spans, runtime calls) of a profile's raw events
    (``kineto_results.events()``), in us on the clock of ``mark_ns``: the
    ``perf_counter_ns`` taken inside the ``MARK`` annotation."""
    from torch.autograd import DeviceType

    mark = next(e for e in events if e.name() == MARK and e.device_type() == DeviceType.CPU)
    shift = mark_ns - mark.start_ns()

    def us(ns):
        return (ns + shift) / 1e3

    runtime, by_corr = [], {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name().startswith("cu"):
            span = Span(us(e.start_ns()), us(e.end_ns()), e.name())
            runtime.append(span)
            by_corr[e.correlation_id()] = span
    dev = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() or e.name() == MARK:
            continue
        call, start = by_corr.get(e.correlation_id()), us(e.start_ns())
        dev.append(DeviceSpan(start, us(e.end_ns()), e.name(),
                              call.start if call is not None else start))
    return dev, runtime


def profiled(fn, targets, calls: int, device, sync) -> dict:
    """Runs ``fn`` once under the profiler with a span recorded around
    every call of ``targets`` and returns ``summarize`` of it over
    ``calls`` calls (``sync`` waits for the device)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    recorded = []
    with layer_spans(targets, recorded), profile(activities=activities) as prof:
        with record_function(MARK):
            mark_ns = time.perf_counter_ns()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev, runtime = spans_of(prof.profiler.kineto_results.events(), mark_ns)
    layers = [Span(s / 1e3, e / 1e3, label) for label, s, e in recorded]
    return summarize(dev, runtime, layers, wall_ms, calls)
