"""Cell ``search_rerank_b1_1536d500k``: interactive users' reranked top-10.

A default ``QragEngine`` over a default ``DeviceFlatIndex`` of 500,000
unit rows of d=1536 is served by ``serve_in_thread`` (no batching).
Every request is ``POST /search_rerank`` on loopback HTTP with one query
vector, k=10, candidates=100 (the default "quantum" reranker: the fused
analytic fidelity rerank), every query distinct.  The traffic is
VectorDBBench's two search tests: its serial test (one client sends the
next query when the last reply is in) gives the latency, p50 and p99 of
2,000 requests after 200 warm-up ones; its concurrent test (closed-loop
clients at a level of its default ``NUM_CONCURRENCY`` sweep, 5, the one
nearest a few interactive users) gives requests/s over 2,000 more.

Outside the timed window every timed reply is held against the plain
reference of this file: the f32 oracle's top-100 (``common.Oracle``),
the analytic fidelity of the same features in numpy float64, a stable
top-10.  A request that errors or returns another answer is failed."""

from __future__ import annotations

import http.client
import json
import math
import threading
import time

import numpy as np
import torch

from bench_cells import CELLS, common
from bench_cells.common import Metric

CELL = "search_rerank_b1_1536d500k"
ROWS, DIM = 500_000, 1536
K, CANDIDATES = 10, 100
WARM_REQUESTS, SERIAL_REQUESTS = 200, 2000
CONCURRENCY, CONCURRENT_REQUESTS = 5, 2000
TRACED_REQUESTS = 200
N_QUBITS = 4  # the default QragConfig's quantum.n_qubits

# bounds: twice the spread ((max - min) / median) of five fresh-process
# runs in one call on an NVIDIA H100 80GB HBM3 (700.00 W), rounded up:
# p50 0.516, p99 0.427, requests/s 0.213, all host-bound; no request may
# fail (PERF.md §2)
METRICS = {
    "latency_p50_ms": Metric("ms", "lower", 1.04),
    "latency_p99_ms": Metric("ms", "lower", 0.86),
    "requests_per_s": Metric("requests/s", "higher", 0.43),
    "failed_requests": Metric("requests", "lower", 0.0),
}


def features64(vectors: np.ndarray, chunk: int = 65536) -> np.ndarray:
    """(n, N_QUBITS): the rotation encoding's angles in float64, the
    first ``N_QUBITS`` components of each unit-normalised row."""
    out = np.empty((vectors.shape[0], N_QUBITS))
    for s in range(0, vectors.shape[0], chunk):
        v = vectors[s : s + chunk].astype(np.float64)
        out[s : s + chunk] = v[:, :N_QUBITS] / np.linalg.norm(v, axis=1, keepdims=True)
    return out


def fidelity64(qf: np.ndarray, df: np.ndarray) -> np.ndarray:
    """The analytic fidelity of the rotation encoding in float64, from
    ``features64``: per qubit, with tq, td the angles x pi/2,
    |<psi_q|psi_d>|^2 = a^2 + b^2 + 2ab cos(tq - td), a = cos(tq) cos(td),
    b = sin(tq) sin(td); the product over qubits.  (B, n) x (B, C, n)
    -> (B, C)."""
    hq, hd = qf[:, None, :] * (math.pi / 2), df * (math.pi / 2)
    a = np.cos(hq) * np.cos(hd)
    b = np.sin(hq) * np.sin(hd)
    return np.prod(a * a + b * b + 2.0 * a * b * np.cos(hq - hd), axis=-1)


def inputs(seed: int, device):
    """(rows (ROWS, DIM), queries (warm-up, serial then concurrent, DIM)):
    host f32 unit rows made on ``device`` from ``seed``."""
    rows = common.seeded_rows(ROWS, DIM, seed, device)
    queries = common.seeded_rows(WARM_REQUESTS + SERIAL_REQUESTS + CONCURRENT_REQUESTS, DIM,
                                 common.query_seed(seed), device)
    return rows, queries


def check(rows, queries, replies, device, chunk=128) -> common.Check:
    """Each reply against the reference: the oracle's top-100, their
    float64 fidelity, a stable top-10.  Each position holds the
    reference's row or one whose fidelity lies within 1e-5 of it, and
    every returned row is one of the oracle's top-100 up to a goodness
    tie within 1e-5; the returned fidelities lie within 1e-5 of the
    reference's.  A reply that errored is wrong.  The check's
    ``max_index_gap`` is the larger of the fidelity gap at a position of
    another row and the goodness by which a row falls short of the
    top-100."""
    oracle = common.Oracle(rows, device)
    feats, qfeats = features64(rows), features64(queries)
    errored = np.array([r is None for r in replies])
    ok = np.flatnonzero(~errored)
    checks = []
    for s in range(0, len(ok), chunk):
        at = ok[s : s + chunk]
        got = np.array([[h[0] for h in replies[i]] for i in at], np.int64)
        got_fid = np.array([[h[1] for h in replies[i]] for i in at])
        g = oracle.goodness(queries[at])
        cand = oracle.order(g, CANDIDATES)
        floor = g.gather(1, cand[:, -1:]).cpu().numpy()
        got_g = g.gather(1, torch.from_numpy(got).to(g.device)).cpu().numpy()
        cand = cand.cpu().numpy()
        fid = fidelity64(qfeats[at], feats[cand])  # (b, C)
        sel = np.argsort(-fid, axis=1, kind="stable")[:, :K]
        want, want_fid = np.take_along_axis(cand, sel, 1), np.take_along_axis(fid, sel, 1)
        c = common.compare(got, want, fidelity64(qfeats[at], feats[got]), want_fid,
                           got_fid, want_fid)
        short = np.maximum(floor.astype(np.float64) - got_g, 0.0)  # below the top-100
        outside = (short > common.TIE_TOL).any(axis=1)
        checks.append(c._replace(bad=c.bad | outside, index_bad=c.index_bad | outside,
                                 max_index_gap=max(c.max_index_gap, float(short.max()))))
    none = np.zeros(0, bool)
    merged = common.merge(checks or [common.Check(none, none, none, 0, 0.0, 0.0)])
    bad, index_bad, value_bad = errored.copy(), np.zeros_like(errored), np.zeros_like(errored)
    bad[ok], index_bad[ok], value_bad[ok] = merged.bad, merged.index_bad, merged.value_bad
    return merged._replace(bad=bad, index_bad=index_bad, value_bad=value_bad)


class _Client:
    """One closed-loop client on a kept-alive loopback connection."""

    def __init__(self, port: int):
        self.port = port
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)

    def send(self, body: bytes):
        """(ms from send to the parsed reply, its k (row, fidelity) hits, or
        None if the request failed or the reply is malformed)."""
        t0 = time.perf_counter()
        try:
            self.conn.request("POST", "/search_rerank", body=body,
                              headers={"Content-Type": "application/json"})
            resp = self.conn.getresponse()
            out = json.loads(resp.read())
            ok = resp.status == 200 and "error" not in out
        except (OSError, http.client.HTTPException, ValueError):
            self.conn.close()
            self.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
            out, ok = None, False
        ms = 1e3 * (time.perf_counter() - t0)
        if ok and out.get("reranker_used") == "quantum" and len(out["results"]) == 1:
            hits = [(h["index"], h["score"]) for h in out["results"][0]]
            if len(hits) == K and all(isinstance(i, int) and 0 <= i < ROWS for i, _ in hits):
                return ms, hits
        return ms, None


def drive(port: int, bodies, clients: int) -> tuple:
    """``bodies`` sent by ``clients`` closed-loop clients, each taking
    the next body when its reply is in: (wall s, per-request ms, replies)."""
    ms, replies = [None] * len(bodies), [None] * len(bodies)
    lock, nxt = threading.Lock(), [0]

    def client():
        c = _Client(port)
        try:
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(bodies):
                    return
                ms[i], replies[i] = c.send(bodies[i])
        finally:
            c.conn.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, ms, replies


def _bodies(queries: np.ndarray) -> list:
    return [json.dumps({"vectors": [q.tolist()], "k": K, "candidates": CANDIDATES}).encode()
            for q in queries]


def trace(engine, port, bodies, device) -> dict:
    """A traced run of ``bodies`` (sent serially, as the latency is timed), with spans at
    the engine call, its choice of candidate mode, the fused rerank, its
    bounded candidate stage (scan front end, certify tail), the
    fidelity, the final top-k and the reply's assembly; the HTTP round
    trip beside the engine call."""
    from bench_cells import trace as tr
    from qrag_tpu_torch import engine as engine_mod
    from qrag_tpu_torch.ops import bounded_topk, statevector

    rtt = []
    targets = [(engine, "search_rerank", "engine.search_rerank"),
               (engine_mod, "fused_search_rerank", "fused_search_rerank"),
               (bounded_topk, "bounded_exact_topk", "candidates: bounded_exact_topk"),
               (engine, "_fused_candidate_mode", "candidate mode"),
               (bounded_topk, "window_bounds_bf16", "candidates: K1 + window bounds"),
               (bounded_topk, "_certify_escalate", "candidates: certify tail"),
               (statevector, "fidelity_from_features", "rerank: fidelity"),
               (engine_mod, "top_k", "rerank: top-k"),
               (engine, "_build_hits", "reply assembly")]
    out = tr.profiled(lambda: rtt.extend(drive(port, bodies, 1)[1]), targets, len(bodies),
                      device, lambda: common.sync(device))
    out["http_round_trip_p50_ms"] = common.percentiles(rtt, 50)[0]
    return out


def run(seed: int, device, traced: bool = False) -> dict:
    from qrag_tpu_torch.config import QragConfig
    from qrag_tpu_torch.engine import QragEngine
    from qrag_tpu_torch.ops.cuda import fused_scan
    from qrag_tpu_torch.serving.http_app import serve_in_thread

    device = torch.device(device)
    t0 = time.perf_counter()
    rows, queries = inputs(seed, device)
    timed = SERIAL_REQUESTS + CONCURRENT_REQUESTS
    # the default config (its embedding width is 1536)
    engine = QragEngine(QragConfig.from_dict({"embedding": {"dim": DIM}}), device=device)
    engine.index.add(rows)
    warm_s = engine.warmup(batch_sizes=(1,))
    setup_s = time.perf_counter() - t0
    bodies = _bodies(queries)
    warm, serial, concurrent = (bodies[:WARM_REQUESTS],
                                bodies[WARM_REQUESTS : WARM_REQUESTS + SERIAL_REQUESTS],
                                bodies[WARM_REQUESTS + SERIAL_REQUESTS :])

    server = serve_in_thread(engine)
    try:
        port = server.server_address[1]
        drive(port, warm, 1)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        fused_scan.reset_launches()
        serial_s, ms, replies = drive(port, serial, 1)
        concurrent_s, _, more = drive(port, concurrent, CONCURRENCY)
        replies += more
        launches = dict(fused_scan.arm_launches)
        peak_mib = (torch.cuda.max_memory_allocated(device) / 2**20
                    if device.type == "cuda" else None)
        t0 = time.perf_counter()
        check_result = check(rows, queries[WARM_REQUESTS:], replies, device)
        check_s = time.perf_counter() - t0
        trace_out = (trace(engine, port, serial[:TRACED_REQUESTS], device)
                     if traced else None)
        trace_s = time.perf_counter() - t0 - check_s
    finally:
        server.shutdown()
        server.server_close()
    errors = []
    if device.type == "cuda" and not sum(launches.values()):
        errors.append("the packed window scan kernel (K1) was not launched")
    failed = int(check_result.bad.sum())
    p50, p99 = common.percentiles(ms, 50, 99)
    name, card = common.card(device)
    return {
        "cell": CELL,
        "configuration": CELLS[CELL].configuration,
        "seed": seed,
        "device": name,
        "card": card,
        "torch": torch.__version__,
        "metrics": common.metric_values({
            "latency_p50_ms": p50,
            "latency_p99_ms": p99,
            "requests_per_s": CONCURRENT_REQUESTS / concurrent_s,
            "failed_requests": failed,
        }, METRICS),
        "counts": {
            "rows": ROWS, "dim": DIM, "k": K, "candidates": CANDIDATES,
            "serial_requests": SERIAL_REQUESTS, "concurrency": CONCURRENCY,
            "concurrent_requests": CONCURRENT_REQUESTS, "attempted_requests": timed,
            "errored_requests": sum(r is None for r in replies),
            "k1_launches_timed_by_arm": launches,
        },
        "setup": {"data_engine_warmup_s": setup_s, "engine_warmup_s": warm_s,
                  "serial_s": serial_s, "concurrent_s": concurrent_s,
                  "peak_device_mib_timed": peak_mib,
                  "check_s": check_s, "trace_s": trace_s},
        "check": {**check_result.readings(), "errors": errors},
        "correct": failed == 0 and not errors,
        "trace": trace_out,
    }
