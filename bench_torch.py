#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: exact top-10 dense
retrieval throughput on a 1M x 768 corpus, one GPU.

The counterpart of ``bench.py``, section by section and under the same
names (``make_corpus``, ``run``, ``bench_bounded_mode``,
``bench_matmul_floor``, ``bench_fused_rerank``, ``bench_int8``,
``bench_accel_latency``, ``main``), over ``qrag_tpu_torch``'s modules.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "qps", "vs_baseline": N, "extra": {...}}

``value`` is the queries/s of the PROVABLY-EXACT bounded top-10
(``ops/bounded_topk.py``: the packed window scan kernel, then the
certified refine; exact identity and tie order).  ``vs_baseline`` is
``value / extra.bound_qps``: ``bound_qps`` is B / ``bound_ms``, the
least time the card could take for the batch's scan, max(2 B N d / the
bf16 dense tensor-core peak, the bytes the call must read and write /
the memory rate), from the H100 SXM data sheet.  ``extra`` carries
``bench.py``'s companions under its keys, every repetition's ms a batch
(``*_reps_ms``), each section's peak device memory (``*_peak_mib``),
and the card's name and power limit.

Timing: each section times ``iters`` dependent eager calls of its step
function (``q + 1e-9 * vals[:, :1]`` feeds the next call) between two
``torch.cuda.synchronize()``, best of ``BEST_OF`` passes after one warm
call.  A bf16 query does not change under that update, so every pass of
a bf16 section sends the same queries: a batch that falls back to the
exact full sort does so in every step.  ``bounded_fallback_rate``
runs the headline's step over ``DISTINCT_BATCHES`` different batches.

Failures are not hidden: a section that raises goes into
``extra.section_errors``, later sections still run, the line is printed
and the process exits 1.  Past ``QRAG_BENCH_DEADLINE_S`` a watchdog
prints a diagnostic line and exits 3.  Without CUDA and without
``--device cpu`` it prints a diagnostic line and exits 2; it never runs
on the CPU unasked.

Usage: python3 bench_torch.py [--small] [--mode approx|exact|verified]
       [--all] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import torch

RESULTS: dict = {}  # filled as sections finish; the watchdog flushes it
_SECTION = ["startup"]
_JSON_PRINTED = threading.Event()

DEADLINE_S = float(os.environ.get("QRAG_BENCH_DEADLINE_S", 1320))

# (n, d, B, iters): bench.py's TPU sizes on the card, its small sizes
# with --small or on the CPU
FULL_SIZES = (1_000_000, 768, 1024, 48)
SMALL_SIZES = (100_000, 768, 256, 5)
BEST_OF = 3  # steady-state throughput: best of N timed passes
DISTINCT_BATCHES = 48  # query batches of the fallback-rate companion
ACCEL_ITERS = 32
CORPUS_CHUNK = 131072  # rows generated at a time (bounds f32 temporaries)

# one H100 SXM (NVIDIA's data sheet, dense): memory rate, bf16 peak
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12

EXIT_SECTION_FAILED = 1
EXIT_NO_CUDA = 2
EXIT_DEADLINE = 3


def _metric(n: int, d: int, device: torch.device) -> str:
    return f"retrieval_qps_exact_top10_{n}x{d}_{'1gpu' if device.type == 'cuda' else 'cpu'}"


def _emit_json(payload: dict) -> None:
    if _JSON_PRINTED.is_set():
        return
    _JSON_PRINTED.set()
    print(json.dumps(payload), flush=True)


def _diagnostic_payload(error: str, extra: dict) -> dict:
    return {
        "metric": RESULTS.get("metric", _metric(*FULL_SIZES[:2], torch.device("cuda"))),
        "value": RESULTS.get("value", 0.0),
        "unit": "qps",
        "vs_baseline": RESULTS.get("vs_baseline", 0.0),
        "error": error,
        "extra": {**RESULTS.get("extra", {}), **extra},
    }


def _start_watchdog() -> None:
    """Past the deadline: print what was measured and exit non-zero (a
    hung device call blocks the main thread, so only another thread can
    still write the line)."""
    deadline = time.time() + DEADLINE_S

    def fire():
        remaining = deadline - time.time()
        while remaining > 0:
            time.sleep(min(remaining, 5.0))
            if _JSON_PRINTED.is_set():
                return
            remaining = deadline - time.time()
        if _JSON_PRINTED.is_set():
            return
        payload = _diagnostic_payload(
            f"bench_deadline_{int(DEADLINE_S)}s_exceeded_in_{_SECTION[0]}",
            {"completed_sections": sorted(RESULTS.get("extra", {}))},
        )
        os.write(1, (json.dumps(payload) + "\n").encode())
        os._exit(EXIT_DEADLINE)

    threading.Thread(target=fire, daemon=True, name="bench-watchdog").start()


def _parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--small", action="store_true", help="bench.py's small sizes")
    parser.add_argument("--mode", default="approx", choices=["approx", "exact", "verified"])
    parser.add_argument("--all", action="store_true", help="every companion")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu (the plain path, small sizes)")
    return parser.parse_args(argv)


def _card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------------ data

_CORPUS_CACHE: dict = {}


def make_corpus(n: int, d: int, dtype, device) -> torch.Tensor:
    """Unit-norm random corpus made on the device from seed 0,
    ``CORPUS_CHUNK`` rows at a time (one f32 chunk alive at a time);
    cached by (n, d, dtype, device)."""
    device = torch.device(device)
    key = (n, d, dtype, str(device))
    if key in _CORPUS_CACHE:
        return _CORPUS_CACHE[key]
    gen = torch.Generator(device).manual_seed(0)
    corpus = torch.empty((n, d), dtype=dtype, device=device)
    for s in range(0, n, CORPUS_CHUNK):
        x = torch.randn((min(CORPUS_CHUNK, n - s), d), generator=gen, device=device)
        corpus[s : s + x.shape[0]] = (x / torch.linalg.norm(x, dim=1, keepdim=True)).to(dtype)
        del x
    _CORPUS_CACHE[key] = corpus
    return corpus


def unit_queries(b: int, d: int, seed: int, dtype, device) -> torch.Tensor:
    """(b, d) unit rows from ``seed`` on the device, cast to ``dtype``."""
    gen = torch.Generator(device).manual_seed(seed)
    q = torch.randn((b, d), generator=gen, device=device)
    return (q / torch.linalg.norm(q, dim=1, keepdim=True)).to(dtype)


def row_sqnorms(corpus: torch.Tensor) -> torch.Tensor:
    """(N,) f32 squared norms, upcast a block of rows at a time."""
    from qrag_tpu_torch.ops.scan_topk import f32_blocks

    return torch.cat([torch.sum(x * x, dim=1) for _, x in f32_blocks(corpus)])


def scan_bound(n: int, d: int, b: int, k: int):
    """(bound ms, "operations" or "bytes") of one bounded call over a bf16
    corpus: 2 B N d operations over the bf16 dense peak, or the bytes it
    must move (the corpus, queries, row norms, window norms and lane
    ranks read once, the (B, k) results written once) over the memory
    rate."""
    ops = 2.0 * b * n * d
    nbytes = (n + b) * d * 2 + n * 4 * 2 + (n // 128) * 4 + b * k * (4 + 8)
    t_ops, t_bytes = ops / BF16_FLOPS_S, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------------ timing


class Timed(NamedTuple):
    ms: float  # ms a batch, best pass
    reps_ms: list  # ms a batch of every pass
    counts: list  # the tallied outputs summed over the last pass
    q: torch.Tensor  # the queries of the last step
    out: tuple  # that step's outputs


def _timed_best(step, q0: torch.Tensor, iters: int, tally=(), reps=None) -> Timed:
    """One warm call, then ``reps`` (default ``BEST_OF``) passes of
    ``iters`` dependent calls of ``step`` (its first output's first
    column feeds the next queries), each pass between two synchronizes.
    ``tally`` names output positions (flags, counts) summed over a
    pass."""
    device = q0.device
    step(q0)
    _sync(device)
    reps_ms = []
    for _ in range(reps or BEST_OF):
        q, sums = q0, [0] * len(tally)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            last_q, out = q, step(q)
            sums = [s + out[p] for s, p in zip(sums, tally)]
            q = q + (1e-9 * out[0][:, :1]).to(q.dtype)
        _sync(device)
        reps_ms.append(1e3 * (time.perf_counter() - t0) / iters)
    return Timed(min(reps_ms), reps_ms, [int(s) for s in sums], last_q, out)


# ------------------------------------------------------------ step functions


class BoundedBuffers(NamedTuple):
    corpus: torch.Tensor  # (N, d) bf16: the scan form and the store
    sqnorms: torch.Tensor  # (N,) f32
    maxnorms: torch.Tensor  # (N/128,) f32
    lane_rank: torch.Tensor  # (1, N) int32


def bounded_buffers(corpus: torch.Tensor) -> BoundedBuffers:
    from qrag_tpu_torch.ops.bounded_topk import window_maxnorms_device
    from qrag_tpu_torch.ops.window_scan import make_lane_rank

    sq = row_sqnorms(corpus)
    return BoundedBuffers(
        corpus, sq, window_maxnorms_device(sq), make_lane_rank(corpus.shape[0], corpus.device)
    )


def bounded_step(q, bufs: BoundedBuffers, k: int):
    """One bounded-exact top-k: (goodness desc, indices, fell_back,
    escalated)."""
    from qrag_tpu_torch.ops.bounded_topk import bounded_exact_topk

    vals, idx, fell_back, _, escalated = bounded_exact_topk(
        q, bufs.corpus, bufs.corpus, bufs.sqnorms, bufs.maxnorms, bufs.lane_rank, k,
        metric="l2",
    )
    return vals, idx, fell_back, escalated


def retrieval_step(q, corpus, sq, k: int, mode: str):
    """The (B, N) f32 goodness and its top-k in ``mode``: (vals, idx)."""
    from qrag_tpu_torch.ops.topk import _goodness, goodness_topk

    return goodness_topk(_goodness(q, corpus, "l2", sq, None), k, mode=mode)


def verified_step(q, corpus, sq, k: int):
    """Verified-exact top-k (deep selection, certificate, exact sort of
    the failing rows): (distances, idx, fallback rows)."""
    from qrag_tpu_torch.ops.topk import scan_topk_verified_jit

    return scan_topk_verified_jit(q, corpus, k, metric="l2", corpus_sqnorms=sq)


def floor_step(q, corpus):
    """The scan's floor: the bf16 product (f32 accumulation and output)
    and its row max."""
    qb = q.to(corpus.dtype)
    if corpus.is_cuda:
        dots = torch.mm(qb, corpus.T, out_dtype=torch.float32)
    else:  # the CPU has no bf16 -> f32 product: upcast (exact for bf16)
        dots = qb.float() @ corpus.float().T
    return (torch.amax(dots, dim=1, keepdim=True),)


def fused_rerank_step(q, corpus, sq, feats, k: int, cands: int, mode: str, fused: bool,
                      n_qubits: int = 10):
    """Retrieval of ``cands`` candidates; with ``fused`` their
    ``n_qubits`` analytic fidelity to the query and its top-k."""
    from qrag_tpu_torch.ops.statevector import fidelity_from_features, rotation_features
    from qrag_tpu_torch.ops.topk import _goodness, goodness_topk, top_k

    vals, idx = goodness_topk(_goodness(q, corpus, "l2", sq, None), cands, mode=mode,
                              oversample=1)
    if fused:
        fid = fidelity_from_features(rotation_features(q.float(), n_qubits), feats[idx])
        vals, sel = top_k(fid, k)
        idx = idx.gather(1, sel)
    return vals, idx


def int8_step(q, corpus, sq, x8, xs, k: int):
    """Int8 scan of 4k candidates, then their exact re-score: (vals, idx)."""
    from qrag_tpu_torch.ops.quantize import int8_scan_topk, quantize_rows, refine_candidates

    q8, q_scale = quantize_rows(q)
    g, idx = int8_scan_topk(q8, q_scale, x8, xs, 4 * k, metric="l2", corpus_sqnorms=sq,
                            query_sqnorms=torch.sum(q * q, dim=-1))
    return refine_candidates(q, corpus, idx, g, k, metric="l2", corpus_sqnorms=sq)


def accel_step(q, groups, k: int):
    """Cluster-pruned exact top-k: (goodness, idx, fell_back, escalated)."""
    from qrag_tpu_torch.ops.cluster_topk import cluster_pruned_topk

    return cluster_pruned_topk(q, groups, k, metric="l2")


# ------------------------------------------------------------------ sections


def run(n, d, b, k, iters, mode, dtype=torch.bfloat16, verbose=False, device="cuda"):
    """``mode`` "approx" / "exact": the f32 goodness matrix and its
    top-k; "verified": ``verified_step``.  Returns (qps, ms a batch,
    fallback rows, Timed)."""
    t0 = time.perf_counter()
    corpus = make_corpus(n, d, dtype, device)
    sq = row_sqnorms(corpus)
    q = unit_queries(b, d, 7, dtype, device)
    if verbose:
        _log(f"corpus {time.perf_counter() - t0:.1f}s")
    if mode == "verified":
        t = _timed_best(lambda qq: verified_step(qq, corpus, sq, k), q, iters, tally=(2,))
        if verbose:
            _log(f"verified fallback rows: {t.counts[0]}/{b * iters}")
        return b * 1e3 / t.ms, t.ms, t.counts[0], t
    t = _timed_best(lambda qq: retrieval_step(qq, corpus, sq, k, mode), q, iters)
    return b * 1e3 / t.ms, t.ms, 0, t


def bench_int8(n, d, b, iters, k=10, device="cuda"):
    """Int8 scan + exact refinement over the bf16 store.  Returns (qps,
    ms a batch, Timed)."""
    from qrag_tpu_torch.ops.quantize import quantize_rows
    from qrag_tpu_torch.ops.scan_topk import f32_blocks

    corpus = make_corpus(n, d, torch.bfloat16, device)
    sq = row_sqnorms(corpus)
    parts = [quantize_rows(x) for _, x in f32_blocks(corpus)]
    x8, xs = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    del parts
    q = unit_queries(b, d, 5, torch.float32, device)
    t = _timed_best(lambda qq: int8_step(qq, corpus, sq, x8, xs, k), q, iters)
    _log(f"int8 scan + exact refine: {t.ms:.2f} ms/batch{b} ({b * 1e3 / t.ms:,.0f} QPS)")
    return b * 1e3 / t.ms, t.ms, t


def bench_matmul_floor(n, d, b, iters, dtype=torch.bfloat16, device="cuda"):
    """The scan's floor: bf16 product + row max.  Returns (ms a batch,
    Timed)."""
    corpus = make_corpus(n, d, dtype, device)
    q = unit_queries(b, d, 11, torch.float32, device)
    t = _timed_best(lambda qq: floor_step(qq, corpus), q, iters)
    return t.ms, t


def rerank_features(corpus, sq, n_qubits=10):
    """(N, n_qubits) rotation features of the corpus, a block at a time."""
    from qrag_tpu_torch.ops.scan_topk import f32_blocks
    from qrag_tpu_torch.ops.statevector import rotation_features

    return torch.cat([
        rotation_features(x, n_qubits, sqnorms=sq[s : s + x.shape[0]])
        for s, x in f32_blocks(corpus)
    ])


def bench_fused_rerank(n, d, b, mode, dtype=torch.bfloat16, cands=100, iters=8,
                       device="cuda"):
    """Quantum-rerank overhead: retrieval of ``cands`` candidates vs
    retrieval + feature-gather fidelity + top-10, same ``cands``.
    Returns (base ms, fused ms, overhead %, {fused: Timed})."""
    corpus = make_corpus(n, d, dtype, device)
    sq = row_sqnorms(corpus)
    q = unit_queries(b, d, 3, dtype, device)
    k, n_qubits = 10, 10
    feats = rerank_features(corpus, sq, n_qubits)
    timed = {}
    for fused in (False, True):
        timed[fused] = _timed_best(
            lambda qq: fused_rerank_step(qq, corpus, sq, feats, k, cands, mode, fused,
                                         n_qubits),
            q, iters,
        )
    base, fused_ms = timed[False].ms, timed[True].ms
    overhead = (fused_ms - base) / base * 100
    _log(f"fused {n_qubits}-qubit fidelity rerank of {cands} candidates: {base:.2f} -> "
         f"{fused_ms:.2f} ms/batch{b} (+{overhead:.1f}% latency)")
    return base, fused_ms, overhead, timed


def bench_bounded_mode(n, d, b, k, iters, query_dtype=torch.bfloat16, device="cuda"):
    """Bounded-exact top-k over a bf16 corpus used as scan and store, n
    rounded up to 512 rows (the extra rows do real work).  Returns (qps,
    ms a batch, fallback steps, Timed; its counts are [fell_back,
    escalated] steps of the last pass)."""
    n = -(-n // 512) * 512
    bufs = bounded_buffers(make_corpus(n, d, torch.bfloat16, device))
    q = unit_queries(b, d, 11, query_dtype, device)
    t = _timed_best(lambda qq: bounded_step(qq, bufs, k), q, iters, tally=(2, 3))
    return b * 1e3 / t.ms, t.ms, t.counts[0], t


def bench_bounded_distinct(n, d, b, k, batches, device="cuda"):
    """The headline's step over ``batches`` different query batches
    (seeds 11, 12, ...; the first is the headline's): the share that
    falls back and that escalates, and the ms a batch of one pass."""
    n = -(-n // 512) * 512
    bufs = bounded_buffers(make_corpus(n, d, torch.bfloat16, device))
    qs = [unit_queries(b, d, 11 + i, torch.bfloat16, device) for i in range(batches)]
    bounded_step(qs[0], bufs, k)
    _sync(torch.device(device))
    fb = esc = 0
    t0 = time.perf_counter()
    for q in qs:
        _, _, f, e = bounded_step(q, bufs, k)
        fb, esc = fb + f, esc + e
    _sync(torch.device(device))
    return fb / batches, esc / batches, 1e3 * (time.perf_counter() - t0) / batches


def clustered_corpus(n, d, device):
    """``bench.py``'s clustered recipe from seed 42: max(16, n/4096) unit
    centers, spread 0.25/sqrt(d), unit rows in bf16."""
    n_centers = max(16, n // (512 * 8))
    spread = 0.25 / float(d) ** 0.5
    gen = torch.Generator(device).manual_seed(42)
    centers = torch.randn((n_centers, d), generator=gen, device=device)
    centers = centers / torch.linalg.norm(centers, dim=1, keepdim=True)
    which = torch.randint(0, n_centers, (n,), generator=gen, device=device)
    corpus = torch.empty((n, d), dtype=torch.bfloat16, device=device)
    for s in range(0, n, CORPUS_CHUNK):
        e = min(s + CORPUS_CHUNK, n)
        x = centers[which[s:e]] + spread * torch.randn((e - s, d), generator=gen,
                                                       device=device)
        corpus[s:e] = (x / torch.linalg.norm(x, dim=1, keepdim=True)).to(torch.bfloat16)
        del x
    return corpus


def bench_accel_latency(n, d, k=10, device="cuda"):
    """Small-batch latency: cluster-pruned exact search vs the bounded
    scan on a clustered corpus (n rounded up to 2048).  Returns the
    ``accel_*`` entries of ``extra``."""
    from qrag_tpu_torch.ops.cluster_topk import build_clustered_groups

    device = torch.device(device)
    n = -(-n // 2048) * 2048
    corpus = clustered_corpus(n, d, device)
    _sync(device)
    t0 = time.perf_counter()
    groups = build_clustered_groups(corpus, group_rows=512)
    _sync(device)
    out = {"accel_build_s": time.perf_counter() - t0}
    bufs = bounded_buffers(corpus)
    for b in (1, 8):
        gen = torch.Generator(device).manual_seed(b)
        rows = torch.randint(0, n, (b,), generator=gen, device=device)
        q = corpus[rows].float() + (0.1 / float(d) ** 0.5) * torch.randn(
            (b, d), generator=gen, device=device)
        tc = _timed_best(lambda qq: accel_step(qq, groups, k), q, ACCEL_ITERS, tally=(2, 3))
        tb = _timed_best(lambda qq: bounded_step(qq, bufs, k), q.to(torch.bfloat16),
                         ACCEL_ITERS)
        out[f"accel_b{b}_ms"] = tc.ms
        out[f"accel_b{b}_reps_ms"] = tc.reps_ms
        out[f"accel_b{b}_bounded_ms"] = tb.ms
        out[f"accel_b{b}_vs_bounded"] = tb.ms / tc.ms
        out[f"accel_b{b}_fallbacks"] = tc.counts[0]
        out[f"accel_b{b}_escalations"] = tc.counts[1]
        _log(f"small-batch exact latency B={b}: clustered {tc.ms:.3f} ms vs bounded "
             f"{tb.ms:.3f} ms ({tb.ms / tc.ms:.1f}x; fallbacks {tc.counts[0]}/{ACCEL_ITERS})")
    return out


class _section:
    """Names the running section for the watchdog, records its peak
    device memory (``<name>_peak_mib``), frees its tensors after it,
    and isolates its failure: the error goes into
    ``extra.section_errors`` and later sections still run."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        _SECTION[0] = self.name
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        return self

    def __exit__(self, et, ev, tb):
        extra = RESULTS.setdefault("extra", {})
        gc.collect()
        if self.device.type == "cuda":
            extra[f"{self.name}_peak_mib"] = torch.cuda.max_memory_allocated(self.device) / 2**20
            torch.cuda.empty_cache()
        if et is None or not issubclass(et, Exception):
            return False
        msg = f"{et.__name__}: {str(ev)[:300]}"
        extra.setdefault("section_errors", {})[self.name] = msg
        _log(f"SECTION FAILED {self.name}: {msg}")
        return True


def main(args=None) -> int:
    args = args if args is not None else _parse_args()
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        _emit_json(_diagnostic_payload(
            "no_cuda_device: bench_torch.py measures the GPU; pass --device cpu for the "
            "plain path on the CPU", {}))
        return EXIT_NO_CUDA
    n, d, b, iters = SMALL_SIZES if args.small or device.type != "cuda" else FULL_SIZES
    k = 10
    bound_ms, bound_by = scan_bound(-(-n // 512) * 512, d, b, k)
    extra = RESULTS.setdefault("extra", {})
    extra.update(
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        card=_card(device),
        torch=torch.__version__,
        iters=iters,
        best_of=BEST_OF,
        bound_ms=bound_ms,
        bound_by=bound_by,
        bound_qps=b * 1e3 / bound_ms,
    )
    RESULTS["metric"] = _metric(n, d, device)

    # the headline first, so a failure in a companion cannot cost it
    with _section("bounded_headline", device):
        qps_b, per_b, fb_b, t_b = bench_bounded_mode(n, d, b, k, iters, device=device)
        _log(f"bounded-exact top-10: {per_b:.2f} ms/batch{b} ({qps_b:,.0f} QPS), fallback "
             f"steps {fb_b}/{iters}, escalated {t_b.counts[1]}/{iters}")
        RESULTS.update(value=qps_b, vs_baseline=qps_b / extra["bound_qps"])
        extra.update(
            bounded_exact_ms_per_batch=per_b,
            bounded_exact_reps_ms=t_b.reps_ms,
            bounded_fallback_batches=fb_b,
            bounded_escalated_batches=t_b.counts[1],
        )

    with _section("bounded_fallback_rate", device):
        rate, esc_rate, ms = bench_bounded_distinct(n, d, b, k, DISTINCT_BATCHES, device)
        _log(f"bounded-exact over {DISTINCT_BATCHES} distinct batches: fallback rate "
             f"{rate:.3f}, escalation rate {esc_rate:.3f}, {ms:.2f} ms/batch")
        extra.update(bounded_fallback_rate=rate, bounded_escalation_rate=esc_rate,
                     bounded_distinct_ms_per_batch=ms,
                     bounded_distinct_batches=DISTINCT_BATCHES)

    with _section("approx", device):
        qps, per_batch, _, t = run(n, d, b, k, iters, args.mode, verbose=args.all,
                                   device=device)
        extra.update(approx_qps=qps, approx_ms_per_batch=per_batch, approx_reps_ms=t.reps_ms)

    with _section("verified", device):
        qps_v, per_v, fb_v, t = run(n, d, b, k, iters, "verified", verbose=args.all,
                                    device=device)
        _log(f"verified-exact top-10: {per_v:.2f} ms/batch{b} ({qps_v:,.0f} QPS), "
             f"certificate fallback rows {fb_v}")
        extra.update(verified_qps=qps_v, verified_ms_per_batch=per_v,
                     verified_fallback_rows=fb_v, verified_reps_ms=t.reps_ms)

    with _section("bounded_k100", device):
        iters_k100 = max(2, iters // 2)
        qps_b100, per_b100, fb_b100, t = bench_bounded_mode(n, d, b, 100, iters_k100,
                                                            device=device)
        _log(f"bounded-exact top-100: {per_b100:.2f} ms/batch{b} ({qps_b100:,.0f} QPS), "
             f"fallback steps {fb_b100}/{iters_k100}")
        extra.update(bounded_exact_k100_qps=qps_b100, bounded_exact_k100_ms_per_batch=per_b100,
                     bounded_k100_fallback_batches=fb_b100, bounded_k100_iters=iters_k100,
                     bounded_exact_k100_reps_ms=t.reps_ms)

    with _section("matmul_floor", device):
        floor_ms, t = bench_matmul_floor(n, d, b, iters, device=device)
        extra.update(matmul_rowmax_ms_per_batch=floor_ms, matmul_rowmax_reps_ms=t.reps_ms)
        if "bounded_exact_ms_per_batch" in extra:
            extra["exact_over_floor"] = extra["bounded_exact_ms_per_batch"] / floor_ms
        _log(f"bf16 matmul+rowmax: {floor_ms:.2f} ms/batch{b}")

    with _section("fused_rerank", device):
        base_ms, fused_ms, overhead, timed = bench_fused_rerank(n, d, b, args.mode,
                                                                iters=iters, device=device)
        extra.update(rerank_overhead_pct=overhead, rerank_base_ms=base_ms,
                     rerank_fused_ms=fused_ms, rerank_base_reps_ms=timed[False].reps_ms,
                     rerank_fused_reps_ms=timed[True].reps_ms)

    if device.type == "cuda" and not args.all:
        with _section("accel_latency", device):
            extra.update(bench_accel_latency(n, d, device=device))

    if args.all:
        with _section("all_approx_exact", device):
            iters_e = max(2, iters // 4)
            qps_e, _, _, _ = run(n, d, b, k, iters_e, "exact", device=device)
            _log(f"exact mode (full sort): {qps_e:,.0f} QPS")
            extra.update(full_sort_qps=qps_e, full_sort_iters=iters_e)
        with _section("all_mid_regime", device):
            qps_m, per_m, fb_m, _ = bench_bounded_mode(n, d, b, k, iters,
                                                       query_dtype=torch.float32,
                                                       device=device)
            _log(f"bounded-exact MID regime (f32 queries, bf16 store): {per_m:.2f} "
                 f"ms/batch{b} ({qps_m:,.0f} QPS), fallback steps {fb_m}")
            extra.update(bounded_mid_qps=qps_m, bounded_mid_fallback_batches=fb_m)
        with _section("all_int8", device):
            qps_i, per_i, _ = bench_int8(n, d, b, iters, device=device)
            extra.update(int8_qps=qps_i, int8_ms_per_batch=per_i)
        with _section("all_rerank_1k", device):
            base_1k, fused_1k, over_1k, _ = bench_fused_rerank(n, d, b, args.mode,
                                                               cands=1000, device=device)
            extra.update(rerank_1k_overhead_pct=over_1k, rerank_1k_base_ms=base_1k,
                         rerank_1k_fused_ms=fused_1k)
        with _section("all_accel", device):
            extra.update(bench_accel_latency(n, d, device=device))

    _SECTION[0] = "emit"
    errors = extra.get("section_errors")
    payload = {
        "metric": RESULTS["metric"],
        "value": RESULTS.get("value", 0.0),
        "unit": "qps",
        "vs_baseline": RESULTS.get("vs_baseline", 0.0),
        "extra": extra,
    }
    if errors:
        payload["error"] = f"sections_failed: {sorted(errors)}"
    _emit_json(payload)
    return EXIT_SECTION_FAILED if errors else 0


if __name__ == "__main__":
    _ARGS = _parse_args()
    _start_watchdog()
    sys.exit(main(_ARGS))
