#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``qrag_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU path):

1. host: card name and power limit, torch/CUDA/nvcc versions, and the
   IEEE-fp32 matmul settings the exact paths need;
2. build: compiles ``qrag_tpu_torch/csrc/*.cu`` into
   ``build/qrag_tpu_torch/<hash>/``;
3. kernel vs plain twin: the packed window-scan kernel against
   ``bounded_topk.packed_window_scan_top2/top3`` on the same device
   inputs — bit-equal planes on dyadic inputs, the plane contract on
   random ones;
4. exactness through the kernel: the reference's planted near-boundary,
   tie, escalation and fallback corpora (bf16 scan, f32 refine) must
   give the oracle's identity;
5. the main path at a real size: the default-config engine over
   1,000,000 unit rows of d=768 behind ``create_server``, answering
   /search, /search_rerank and /stats over HTTP, checked against the
   f32 oracle and the plain rerank composition; the kernel's launch
   counters must grow for both plane counts;
6. timings (no pass condition).

The last line is the JSON result; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

WINDOW = 128
CAP_1M = 1_250_176  # engine capacity for 1,000,000 rows (25% headroom)


def _sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


def _card_line() -> str:
    return _sh(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).strip().splitlines()[0]


class Smoke:
    def __init__(self, torch, device="cuda", card=None):
        self.torch = torch
        self.dev = torch.device(device)
        self.card = card or _card_line()

    # ------------------------------------------------------------ phase 1-2

    def host(self):
        torch = self.torch
        print(self.card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}")
        from qrag_tpu_torch.ops.cuda._build import _nvcc

        print(_sh([_nvcc(), "--version"]).strip().splitlines()[-1])
        torch.backends.cudnn.allow_tf32 = False
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 matmuls are enabled")
        if torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("float32 matmul precision is not 'highest'")

    def build(self):
        from qrag_tpu_torch.ops.cuda import _build

        t0 = time.perf_counter()
        _build.load_library()
        print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path()}")
        for line in (_build.build_log or "").splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # -------------------------------------------------------------- phase 3

    def _scan_inputs(self, b, n, d, metric, dyadic, seed):
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        if dyadic:
            q = torch.randint(-8, 9, (b, d), generator=g, device=self.dev) / 16
            x = torch.randint(-8, 9, (n, d), generator=g, device=self.dev) / 16
        else:
            q = torch.randn((b, d), generator=g, device=self.dev)
            x = torch.randn((n, d), generator=g, device=self.dev)
            x = x / x.norm(dim=1, keepdim=True)
        q, x = q.bfloat16(), x.bfloat16()
        bias = torch.zeros((1, n), device=self.dev)
        bias[:, 5::7] = -torch.inf  # invalid rows
        alpha, ra, ca = 1.0, bias, None
        if metric == "l2":
            alpha = 2.0
            ra = -(x.float() ** 2).sum(1)[None, :] + bias
            ca = -(q.float() ** 2).sum(1, keepdim=True)
        return q, x, alpha, ra, ca

    def _compare(self, q, x, alpha, ra, ca, planes, dyadic):
        """Kernel vs plain twin.  Dyadic: bit-equal planes.  Random: the
        plane contract — upper value bounds to rtol 1e-4 / atol 1e-3,
        lanes equal where the trunc keys agree (up to truncated ties).
        Returns (max |upper-bound difference|, keys equal, keys)."""
        torch = self.torch
        from qrag_tpu_torch.ops import bounded_topk as bt
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.window_scan import make_lane_rank

        lr = make_lane_rank(x.shape[0], self.dev)
        got = fused_scan.packed_window_scan(q, x, lr, ra, ca, alpha, planes)
        torch.cuda.synchronize()
        twin = bt.packed_window_scan_top3 if planes == 3 else bt.packed_window_scan_top2
        ref = twin(q, x, lr, ra, ca, alpha)
        torch.cuda.synchronize()
        err, n_same, n_all = 0.0, 0, 0
        for g_, r in zip(got, ref):
            if dyadic:
                if not torch.equal(g_, r):
                    raise AssertionError("dyadic planes differ from the twin")
                continue
            _, hi_g = bt.plane_value_bounds(g_)
            lo_r, hi_r = bt.plane_value_bounds(r)
            if not torch.allclose(hi_g, hi_r, rtol=1e-4, atol=1e-3):
                raise AssertionError("plane value bounds outside rtol 1e-4/atol 1e-3")
            err = max(err, (hi_g - hi_r).abs().max().item())
            same = (g_ & ~127) == (r & ~127)
            n_same += int(same.sum())
            n_all += same.numel()
            self._check_lanes(q, x, alpha, ra, ca, g_, lo_r, hi_r, r, same)
        return err, n_same, n_all

    def _check_lanes(self, q, x, alpha, ra, ca, g_, lo_r, hi_r, r, same):
        """Lanes agree wherever the trunc keys agree, except at a
        truncated tie: two rows of one window within one quantum, where
        accumulation drift picks either.  There the kernel's row must
        score, re-evaluated in f32, inside the twin's value bounds
        widened by the plane contract's tolerance."""
        torch = self.torch

        bad = same & ((g_ & 127) != (r & 127))
        if not bool(bad.any()):
            return
        bi, wi = torch.nonzero(bad, as_tuple=True)
        rows = wi * WINDOW + (127 - (g_[bi, wi] & 127))
        s = alpha * (q[bi].float() * x[rows].float()).sum(1) + ra[0, rows]
        if ca is not None:
            s = s + ca[bi, 0]
        lo, hi = lo_r[bi, wi], hi_r[bi, wi]
        tol = 1e-4 * hi.abs() + 1e-3
        if not bool(((s >= lo - tol) & (s <= hi + tol)).all()):
            raise AssertionError("a lane differs where keys agree beyond a trunc tie")
        self.lane_ties = getattr(self, "lane_ties", 0) + int(bad.sum())

    def kernel_vs_twin(self):
        n_cases = 0
        for n in (4096, 4224, CAP_1M):
            for d in (128, 768):
                err, n_same, n_all = 0.0, 0, 0
                for b in (1, 7, 64, 1024):
                    for planes in (2, 3):
                        for metric in ("ip", "l2"):
                            for dyadic in (True, False):
                                inp = self._scan_inputs(
                                    b, n, d, metric, dyadic, seed=n + d + b
                                )
                                e, s_, a_ = self._compare(*inp, planes, dyadic)
                                err, n_same, n_all = max(err, e), n_same + s_, n_all + a_
                                n_cases += 1
                                del inp
                # tensor-core f32 accumulation moves a score across a
                # truncation boundary more often than IEEE order does
                # (one quantum at most on random data); the value bounds
                # above are the binding check, as for the reference's
                # transposed kernel (>= 90% of keys there)
                share = n_same / n_all
                print(f"kernel vs twin: N={n} d={d} B=1,7,64,1024 planes=2,3 "
                      f"ip,l2 dyadic+random: ok (random: max |hi err| {err:.3g}, "
                      f"trunc keys equal {share:.4f})", flush=True)
                if share < 0.9:
                    raise AssertionError(f"only {share:.4f} of trunc keys agree")
        self.torch.cuda.empty_cache()
        print(f"kernel vs twin: {n_cases} cases ok (lanes differing at "
              f"truncated ties: {getattr(self, 'lane_ties', 0)})")

    # -------------------------------------------------------------- phase 4

    def _exact_case(self, name, q, x, metric, k, **kw):
        """bounded_exact_topk through the kernel (bf16 scan, f32 refine)
        against the f32 oracle under the repo's exactness contract."""
        torch = self.torch
        from qrag_tpu_torch.ops import bounded_topk as bt
        from qrag_tpu_torch.ops.window_scan import make_lane_rank

        qt = torch.from_numpy(q).to(self.dev)
        xt = torch.from_numpy(x).to(self.dev)
        sq = (xt * xt).sum(1)
        mx = bt.window_maxnorms_device(sq)
        vals, idx, fb, npatch, esc = bt.bounded_exact_topk(
            qt, xt.bfloat16(), xt, sq, mx, make_lane_rank(x.shape[0], self.dev),
            k, metric=metric, **kw,
        )
        ov, oi = bt._exact_full_sort(qt, xt, sq, k, metric, None)
        from qrag_tpu_torch.ops.topk import _goodness

        g = _goodness(qt, xt, metric, sq, None)
        ties = _check_exact(idx, vals, oi, ov, g, atol=5e-3)
        print(f"exact: {name}: ok (fell_back={fb} escalated={esc} "
              f"patched={int(npatch)} sub-noise tie reorders={ties})", flush=True)

    def exactness(self):
        W = WINDOW
        for metric in ("ip", "l2"):  # trap 6: planted near-boundary rows
            rng = np.random.RandomState(0)
            x = rng.randn(32768, 128).astype(np.float32)
            x /= np.linalg.norm(x, axis=1, keepdims=True)
            q = rng.randn(8, 128).astype(np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            step = 5e-3 if metric == "l2" else 1e-4
            for j in range(24):
                x[128 * (7 * j + 1) + (j % W)] = q[0] * (1.0 - step * j)
            self._exact_case(f"bf16 margins {metric}", q, x, metric, 10)
        rng = np.random.RandomState(1)
        x = rng.randn(32768, 128).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q = rng.randn(6, 128).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        for j in range(10):
            w = 11 * j + 3
            x[w * W + 2] = q[0] * (1.0 - 5e-3 * j)
            x[w * W + 77] = q[0] * (1.0 - 5e-3 * j - 1e-3)
        self._exact_case("large-k bf16 margins", q, x, "l2", 48)
        rng = np.random.RandomState(2)
        x = np.tile(rng.randn(32, 16).astype(np.float32), (128, 1))
        self._exact_case("tie break", rng.randn(3, 16).astype(np.float32), x, "ip", 12)
        for name, count, stride in (("escalation", 20, 2), ("fallback", 40, 1)):
            rng = np.random.RandomState(3)
            x = rng.randn(8192, 16).astype(np.float32)
            q = rng.randn(4, 16).astype(np.float32)
            t = q[0] / np.linalg.norm(q[0])
            for j in range(count):
                x[j * W * stride + 5] = t * (5.0 + 1e-6 * j)
            self._exact_case(name, q, x, "ip", 6, candidates=8)
        rng = np.random.RandomState(4)
        x = 0.05 * rng.randn(8192, 16).astype(np.float32)
        q = rng.randn(4, 16).astype(np.float32)
        t = q[0] / np.linalg.norm(q[0])
        for wi, w in enumerate((3, 19, 40)):
            x[w * W + 7] = t * (4.0 + 0.01 * wi)
            x[w * W + 90] = t * (4.0 + 0.005 * wi)
        self._exact_case("multi-flag fallback", q, x, "ip", 10)
        for k in (10, 64):
            rng = np.random.RandomState(5)
            x = rng.randn(131072, 64).astype(np.float32)
            q = rng.randn(8, 64).astype(np.float32)
            self._exact_case(f"random 131072x64 k={k}", q, x, "l2", k)
        rng = np.random.RandomState(6)
        x = rng.randn(65536, 256).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q = rng.randn(32, 256).astype(np.float32)
        self._exact_case("dense large-k 65536x256 k=100", q, x, "l2", 100)

    # -------------------------------------------------------------- phase 5

    def main_path(self, n_rows=1_000_000):
        torch = self.torch
        from qrag_tpu.config import QragConfig
        from qrag_tpu_torch.engine import QragEngine
        from qrag_tpu_torch.ops import bounded_topk as bt
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.statevector import (
            fidelity_from_features,
            rotation_features,
        )
        from qrag_tpu_torch.ops.topk import _goodness, top_k
        from qrag_tpu_torch.serving.http_app import create_server

        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        x = rng.standard_normal((n_rows, 768), dtype=np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        cfg = QragConfig.from_dict({"embedding": {"provider": "hash", "dim": 768}})
        engine = QragEngine(config=cfg, device=self.dev)
        engine.index.add(x)
        del x
        snap = engine.index.device_buffers()
        if n_rows == 1_000_000 and snap.matrix.shape != (CAP_1M, 768):
            raise AssertionError(f"capacity {tuple(snap.matrix.shape)}")
        warm = engine.warmup(batch_sizes=(1,))  # derived buffers + first launches
        warm_counts = (
            f"escalations={engine.index.bounded_escalations} "
            f"fallbacks={engine.index.fallback_rows}"
        )
        print(f"main path: {n_rows:,} x 768 rows on {self.dev}, capacity "
              f"{snap.matrix.shape[0]}; setup {time.perf_counter() - t0:.1f} s "
              f"(warmup {warm:.2f} s); device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

        server = create_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        qrng = np.random.default_rng(1)

        def unit(b):
            q = qrng.standard_normal((b, 768), dtype=np.float32)
            return q / np.linalg.norm(q, axis=1, keepdims=True)

        q1, q64, r1, r16 = unit(1), unit(64), unit(1), unit(16)
        try:
            fused_scan.reset_launches()
            s1 = _post(port, "/search", {"vectors": q1.tolist(), "k": 10})
            s64 = _post(port, "/search", {"vectors": q64.tolist(), "k": 10})
            st = _post(port, "/search", {"query": "find the advertisement", "k": 10})
            rr1 = _post(port, "/search_rerank", {"vectors": r1.tolist(), "k": 10, "candidates": 100})
            rr16 = _post(port, "/search_rerank", {"vectors": r16.tolist(), "k": 10, "candidates": 100})
            stats = _get(port, "/stats")
            launches = dict(fused_scan.launches)
            print(f"main path launches: {launches}")
            if launches[2] < 1 or launches[3] < 1:
                raise AssertionError(f"kernel not launched for both plane counts: {launches}")

            def oracle(q, k):
                qt = torch.from_numpy(q).to(self.dev)
                v, i = bt._exact_full_sort(qt, snap.matrix, snap.sqnorms, k, "l2", snap.valid)
                return qt, v, i

            qtext = engine.embedder(["find the advertisement"])
            ties = 0
            for q, resp in ((q1, s1), (q64, s64), (qtext, st)):
                qt, ov, oi = oracle(q, 10)
                got = np.asarray([[h["index"] for h in r] for r in resp["results"]])
                dist = np.asarray([[h["score"] for h in r] for r in resp["results"]])
                g = _goodness(qt, snap.matrix, "l2", snap.sqnorms, snap.valid)
                ties += _check_exact(
                    torch.from_numpy(got).to(self.dev), -torch.from_numpy(dist).to(self.dev),
                    oi, ov, g, atol=1e-4,
                )
            print(f"/search B=1, B=64, text: indices equal the f32 oracle "
                  f"(sub-noise tie reorders: {ties})")
            for q, resp in ((r1, rr1), (r16, rr16)):
                qt, _, cand = oracle(q, 100)
                feats = rotation_features(
                    snap.matrix[cand].float(), 4, snap.sqnorms[cand]
                )
                fid = fidelity_from_features(rotation_features(qt, 4), feats)
                fv, sel = top_k(fid, 10)
                want = cand.gather(1, sel).cpu().numpy()
                got = np.asarray([[h["index"] for h in r] for r in resp["results"]])
                score = np.asarray([[h["score"] for h in r] for r in resp["results"]])
                if not np.array_equal(got, want):
                    raise AssertionError(f"/search_rerank differs from the plain composition:\n{got}\n{want}")
                np.testing.assert_allclose(score, fv.cpu().numpy(), rtol=1e-5, atol=1e-6)
                if resp["reranker_used"] != "quantum":
                    raise AssertionError(resp["reranker_used"])
            print("/search_rerank B=1, B=16 (k=10, candidates=100): equal to the "
                  "oracle top-100 -> rotation_features -> fidelity -> stable top-10")
            idx_stats = stats["index"]
            print(f"/stats: bounded_escalations={idx_stats['bounded_escalations']} "
                  f"fallback_rows={idx_stats['verified_fallback_rows']} "
                  f"(of which warmup's all-zero query: {warm_counts}) "
                  f"effective_topk_modes={idx_stats['effective_topk_modes']} "
                  f"backend={stats['backend']} devices={stats['devices']}")
            self.timings(engine, port, unit)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        return launches

    # -------------------------------------------------------------- phase 6

    def _events_ms(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def timings(self, engine, port, unit):
        torch = self.torch
        from qrag_tpu_torch.ops import bounded_topk as bt
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.window_scan import make_lane_rank

        snap, (scan, _, _) = engine.index._bounded_buffers()
        lr = make_lane_rank(scan.shape[0], self.dev)
        ra = (-snap.sqnorms + torch.where(snap.valid, 0.0, -torch.inf))[None, :]
        self.kernel_rows = []
        for b in (1024, 1):
            q = torch.from_numpy(unit(b)).to(self.dev)
            ca = -(q * q).sum(1, keepdim=True)
            qb = q.bfloat16()
            for planes in (2, 3):
                twin = bt.packed_window_scan_top3 if planes == 3 else bt.packed_window_scan_top2
                err = self._compare(qb, scan, 2.0, ra, ca, planes, dyadic=False)[0]
                pairs = []
                for _ in range(2):  # plain, kernel, kernel, plain
                    p0 = self._events_ms(lambda: twin(qb, scan, lr, ra, ca, 2.0), 3)
                    k_ms = self._events_ms(
                        lambda: fused_scan.packed_window_scan(qb, scan, lr, ra, ca, 2.0, planes), 20
                    )
                    pairs.append((p0, k_ms))
                plain_ms = float(np.median([p for p, _ in pairs]))
                ms = float(np.median([k for _, k in pairs]))
                print(f"timing [{self.card}]: scan kernel B={b} N={scan.shape[0]} "
                      f"d=768 planes={planes}: kernel {ms:.4f} ms, plain twin "
                      f"{plain_ms:.4f} ms (runs {pairs}); max |hi err| {err:.3g}")
                if b == 1024:
                    self.kernel_rows.append((planes, ms, plain_ms, err))

        for b, k in ((1, 10), (1, 100), (1024, 10), (1024, 100)):
            events = [
                engine.index._bounded_search(
                    torch.from_numpy(unit(b)).to(self.dev), k
                )
                for _ in range(5)
            ]
            print(f"certificates [{self.card}]: B={b} k={k}: escalated "
                  f"{sum(e[4] for e in events)}/5, full sort "
                  f"{sum(e[2] for e in events)}/5, patched windows "
                  f"{[int(e[3]) for e in events]}")
        # ten different random batches: some escalate or fall back to the
        # full sort (the certificate counters tell which)
        runs = []
        for _ in range(10):
            q = unit(1024)
            esc0, fb0 = engine.index.bounded_escalations, engine.index.fallback_rows
            t0 = time.perf_counter()
            engine.index.search(q, k=10)  # ends in a device->host copy
            runs.append((
                1e3 * (time.perf_counter() - t0),
                engine.index.bounded_escalations - esc0,
                engine.index.fallback_rows - fb0,
            ))
        ms = [r[0] for r in runs]
        tier1 = [r[0] for r in runs if not r[1]]
        print(f"timing [{self.card}]: index.search B=1024 k=10 over "
              f"{engine.index.ntotal:,} x 768, 10 random batches: median "
              f"{np.median(ms):.3f} ms ({1024e3 / np.median(ms):.1f} QPS), mean "
              f"{np.mean(ms):.3f} ms ({1024e3 / np.mean(ms):.1f} QPS); "
              f"escalated {sum(r[1] for r in runs)}/10, full sort "
              f"{sum(r[2] for r in runs)}/10; tier-1 batches median "
              f"{np.median(tier1) if tier1 else float('nan'):.3f} ms; "
              f"per batch (ms, escalated, full sort) {[(round(a, 3), b, c) for a, b, c in runs]}")
        lat = []
        for _ in range(20):
            body = {"vectors": unit(1).tolist(), "k": 10, "candidates": 100}
            t0 = time.perf_counter()
            _post(port, "/search_rerank", body)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        print(f"timing [{self.card}]: HTTP /search_rerank B=1 k=10 "
              f"candidates=100: p50 {1e3 * lat[len(lat) // 2]:.3f} ms, "
              f"p90 {1e3 * lat[int(0.9 * len(lat))]:.3f} ms, "
              f"min {1e3 * lat[0]:.3f} ms (20 requests)")


def _check_exact(idx, vals, oi, ov, g, atol):
    """The repo's exactness contract (tests/test_bounded_topk.py
    ``_assert_exact``): identity equals the oracle's except where the
    oracle's own values show a sub-noise tie.  Returns the number of
    tie reorders."""
    import torch

    idx, oi = idx.long(), oi.long()
    diff = idx != oi
    if bool(diff.any()):
        rows, pos = torch.nonzero(diff, as_tuple=True)
        ref = ov[rows, pos]
        gap = (g[rows, idx[rows, pos]] - ref).abs()
        if not bool((gap <= 3e-4 * (1.0 + ref.abs())).all()):
            raise AssertionError(f"non-tie index mismatch at rows {rows.tolist()}")
    if not torch.allclose(vals.float(), ov, rtol=1e-5, atol=atol):
        raise AssertionError("values differ from the oracle")
    return int(diff.sum())


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.load(r)
    if "error" in out:
        raise RuntimeError(f"{path}: {out['error']}")
    return out


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.load(r)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smoke = Smoke(torch)
    smoke.host()
    smoke.build()
    smoke.kernel_vs_twin()
    smoke.exactness()
    launches = smoke.main_path()
    kernels = [
        {
            "name": f"packed_window_scan planes={planes}",
            "route": "cuda",
            "source": "qrag_tpu_torch/csrc/fused_scan.cu",
            "replaces": "qrag_tpu/ops/pallas/fused_scan.py:398",
            "launches": launches[planes],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
        }
        for planes, ms, plain_ms, err in smoke.kernel_rows
    ]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smoke.card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
