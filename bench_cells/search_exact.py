"""Cell ``search_exact_b1024_768d1m``: a batch caller's exact top-10.

One caller in a closed loop calls ``DeviceFlatIndex.search`` (the
Python surface a batch job calls) with B=1024 host f32 query rows and
k=10, and takes the results back on the host.  The index holds
1,000,000 unit rows of d=768 under the default ``QragConfig``: bounded
top-k (the packed window scan kernel, then the certify tail), a bf16
scan copy over the f32 store, l2, normalize.  The same 48 batches go
through one warm-up and three timed passes, so the batches that escalate
or fall back to the full sort are the same in every pass and every run.
Batch latency is read at p50 (a batch the certify tail settles) and at
p95, inside the mode of the batches that fall back (5 of the 48 at seed
0): p90 of a pass sat on the cliff between the two modes.

Outside the timed window the first 64 queries of every batch are held
against the f32 oracle (``common.Oracle``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_cells import CELLS, common
from bench_cells.common import Metric

CELL = "search_exact_b1024_768d1m"
ROWS, DIM = 1_000_000, 768
BATCH, BATCHES, K = 1024, 48, 10
WARM_PASSES, TIMED_PASSES = 1, 12
CHECKED = 64  # queries of each batch held against the oracle

# bounds: twice the spread ((max - min) / median) of five fresh-process
# runs in one call on an NVIDIA H100 80GB HBM3 (700.00 W), rounded up:
# QPS 0.127, p50 0.333, p95 0.026 (PERF.md §2).  p50 is host-bound and
# the host's speed drifts by a third over minutes; p95 is the device's.
METRICS = {
    "qps": Metric("queries/s", "higher", 0.26),
    "batch_latency_p50_ms": Metric("ms", "lower", 0.67),
    "batch_latency_p95_ms": Metric("ms", "lower", 0.06),
}


def inputs(seed: int, device):
    """(rows (ROWS, DIM), queries (BATCHES, BATCH, DIM)): host f32 unit
    rows made on ``device`` from ``seed``."""
    rows = common.seeded_rows(ROWS, DIM, seed, device)
    queries = common.seeded_rows(BATCH * BATCHES, DIM, common.query_seed(seed), device)
    return rows, queries.reshape(BATCHES, BATCH, DIM)


def _index(rows: np.ndarray, device):
    from qrag_tpu_torch.config import QragConfig
    from qrag_tpu_torch.engine import QragEngine

    # the index a default engine builds (its config's defaults), d=768
    index = QragEngine(QragConfig.from_dict({"embedding": {"dim": DIM}}), device=device).index
    index.add(rows)
    index.device_buffers()  # the upload
    return index


def _pass(index, batches, keep):
    """One pass over ``batches``: each call's ms and whether it escalated
    or fell back; with ``keep`` the results too."""
    ms, escalated, fell_back, out = [], [], [], []
    for q in batches:
        esc0, fb0 = index.bounded_escalations, index.fallback_rows
        t0 = time.perf_counter()
        res = index.search(q, k=K)
        ms.append(1e3 * (time.perf_counter() - t0))
        escalated.append(index.bounded_escalations > esc0)
        fell_back.append(index.fallback_rows > fb0)
        if keep:
            out.append((res.indices, res.scores))
    return ms, escalated, fell_back, out


def check(rows, queries, results, device) -> common.Check:
    """The first ``CHECKED`` queries of every batch against the oracle:
    indices equal except between rows whose f32 goodness lies within
    1e-5, distances within 1e-5."""
    oracle = common.Oracle(rows, device)
    checks = []
    for q, (idx, dist) in zip(queries, results):
        g = oracle.goodness(q[:CHECKED])
        want = oracle.order(g, K).cpu().numpy()
        g = g.cpu().numpy()
        got = idx[:CHECKED].astype(np.int64)
        checks.append(common.compare(
            got, want, np.take_along_axis(g, np.maximum(got, 0), axis=1),
            np.take_along_axis(g, want, axis=1), dist[:CHECKED],
            -np.take_along_axis(g, want, axis=1)))
    return common.merge(checks)


def trace(index, batches, device) -> dict:
    """One traced pass over the batches, with spans at the index, the
    bounded op, its scan front end, its certify tail, the full-sort
    fallback and the finalize."""
    from bench_cells import trace as tr
    from qrag_tpu_torch.index import flat_index
    from qrag_tpu_torch.ops import bounded_topk

    targets = [(index, "search", "index.search"),
               (bounded_topk, "bounded_exact_topk", "bounded_exact_topk"),
               (bounded_topk, "window_bounds_bf16", "scan: K1 + window bounds"),
               (bounded_topk, "_certify_escalate", "certify tail"),
               (bounded_topk, "_exact_full_sort", "full-sort fallback"),
               (flat_index, "_finalize", "finalize")]
    return tr.profiled(lambda: _pass(index, batches, False), targets, len(batches), device,
                       lambda: common.sync(device))


def run(seed: int, device, traced: bool = False) -> dict:
    from qrag_tpu_torch.ops.cuda import fused_scan

    device = torch.device(device)
    t0 = time.perf_counter()
    rows, queries = inputs(seed, device)
    index = _index(rows, device)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    passes = [_pass(index, queries, False) for _ in range(WARM_PASSES)]
    warm_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fused_scan.reset_launches()
    t0 = time.perf_counter()
    for p in range(TIMED_PASSES):
        passes.append(_pass(index, queries, p == TIMED_PASSES - 1))
    timed_s = time.perf_counter() - t0
    launches = dict(fused_scan.arm_launches)
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else None

    timed = passes[WARM_PASSES:]
    ms = [m for p in timed for m in p[0]]
    p50, p95 = common.percentiles(ms, 50, 95)
    per_pass = [{"escalated_batches": [i for i, e in enumerate(p[1]) if e],
                 "fallback_batches": [i for i, f in enumerate(p[2]) if f]} for p in passes]
    t0 = time.perf_counter()
    check_result = check(rows, queries, timed[-1][3], device)
    check_s = time.perf_counter() - t0
    errors = []
    if device.type == "cuda" and not sum(launches.values()):
        errors.append("the packed window scan kernel (K1) was not launched")
    t0 = time.perf_counter()
    trace_out = trace(index, queries, device) if traced else None
    trace_s = time.perf_counter() - t0
    name, card = common.card(device)
    return {
        "cell": CELL,
        "configuration": CELLS[CELL].configuration,
        "seed": seed,
        "device": name,
        "card": card,
        "torch": torch.__version__,
        "metrics": common.metric_values({
            "qps": TIMED_PASSES * BATCHES * BATCH / timed_s,
            "batch_latency_p50_ms": p50,
            "batch_latency_p95_ms": p95,
        }, METRICS),
        "counts": {
            "rows": ROWS, "dim": DIM, "batch": BATCH, "batches": BATCHES, "k": K,
            "timed_batches": len(ms),
            "escalations_per_pass": len(per_pass[0]["escalated_batches"]),
            "fallbacks_per_pass": len(per_pass[0]["fallback_batches"]),
            "escalated_batches": per_pass[0]["escalated_batches"],
            "fallback_batches": per_pass[0]["fallback_batches"],
            "k1_launches_timed_by_arm": launches,
            # the same batches escalate and fall back in every pass
            "passes_agree": all(p == per_pass[0] for p in per_pass),
        },
        "setup": {"data_and_index_s": setup_s, "warmup_pass_s": warm_s,
                  "timed_s": timed_s, "peak_device_mib_timed": peak_mib,
                  "check_s": check_s, "trace_s": trace_s},
        "batch_ms": ms,
        "check": {**check_result.readings(), "errors": errors},
        "correct": not check_result.bad.any() and not errors,
        "trace": trace_out,
    }
