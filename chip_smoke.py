#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``qrag_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU path):

1. host: card name and power limit, torch/CUDA/nvcc versions, and the
   IEEE-fp32 matmul settings the exact paths need;
2. build: compiles ``qrag_tpu_torch/csrc/*.cu`` into
   ``build/qrag_tpu_torch/<hash>/``;
3. kernel vs plain twin: the packed window-scan kernel's float domain
   (planes 1-3) against ``window_scan.packed_window_scan`` and
   ``bounded_topk.packed_window_scan_top2/top3`` — bit-equal planes on
   dyadic inputs, the plane contract on random ones — and its int8
   domain (planes 1-2) against ``packed_window_scan`` /
   ``packed_window_scan_top2_int``: bit-equal on every input, clipped
   keys included; both over B on either side of the cut between the
   general and the wide arm, a ragged last query tile (B = 257, 1000)
   and window pair (N = 4224), d = 64, 128, 768 (int8 also 16 and
   8192), and with each arm forced on shapes both take and held against
   the other; the row-gather kernel against ``plain_gather_rows``
   (bit-equal: f32, bf16 and int8 rows, d = 768 and 100, clamped
   indices); the scan_topk kernel (f32 and bf16 compute; the stream,
   wgmma (64 and 128 queries a block), tiled and general arms, each of
   which must be reached)
   against ``plain_scan_topk`` (l2 and ip, valid_rows, planted
   duplicates, k = 1..1024, B and k on both sides of every cut between
   arms, tiles and buffers, d = 768, 100, 13, N below one tile and no
   multiple of one): values within rtol 1e-5, or, where the score cancels
   (a row against its own copy), within 1e-5 * (1 + |q|^2 + |x|^2), the
   scale of f32 summation-order error; indices equal except between
   rows whose scores lie within that tolerance of each other;
4. exactness through the kernel: the reference's planted near-boundary,
   tie, escalation and fallback corpora (bf16 scan, f32 refine; int8
   scan, f32 refine; the int8 own domain) must give the oracle's
   identity, and clipped int8 keys must fall back;
5. the main paths at a real size, one engine at a time over the same
   1,000,000 unit rows of d=768, each behind ``create_server``:
   the default config (/search and /search_rerank against the f32
   oracle and the plain rerank composition; bf16 launches for planes 2
   and 3), (a) ``bounded_scan="int8"`` (the same checks; int8 planes=2
   launches), (b) ``quantization="int8", quant_scan="window"`` on a
   bf16 store (/search equal index for index to the same search on the
   twin's planes, exact and lean; recall against the f32 oracle; int8
   planes=1 launches), then the own-domain index against
   ``full_topk_int8_domain`` and the row scan's recall; and on the
   default engine the routed serving layer: /search_rerank "auto" (a
   mix of keyword and plain text, B=1 and B=64) and "classical", POST
   /rerank with 100 documents on both routes, and a ``--batching``
   server taking concurrent /search and /rerank — each against a plain
   composition (f32 exact top-100, gather, the fidelity or cosine
   expert, stable top-k; or the unbatched engine), with the gather
   kernel's launches counted;
6. timings (no pass condition, but a timed row names the arm whose
   launch count rose, a B=1024 search must launch the wide arm of the
   scan and a B=1 search the general one): the scan kernels vs their
   twins at B = 1, 64 and 1024 beside the bound and the GEMM alone
   (``torch.matmul`` / ``torch._int_mm``), each arm forced at B = 1..256
   (where they cut), index.search B=1024 with a ``torch.profiler``
   breakdown, certificate census; the gather and
   scan_topk kernels beside their twins, their bounds and the library
   calls (``torch.index_select``; matmul + ``torch.topk``, and for the
   bf16 rows a bf16 product, whose output is bf16); the routed
   /search_rerank p50 at B=1.  A kernel is timed three ways: ``ms``,
   back-to-back calls of its wrapper between two CUDA events (host and
   device together); ``device_ms``, the same calls captured in a CUDA
   graph and replayed (the device alone); ``host_us``, the host clock
   over un-synchronised calls (the wrapper's host path alone);
7. the trained models and the MCP ingestion path, with the shipped
   weights (``artifacts/``): the cross-encoder (interaction head, 224
   tokens) and the bi-encoder in bf16 against themselves at f32 (sigmoid
   scores within ``BF16_SCORE_ATOL``, top-10 order but within it,
   cosine at or above ``BF16_COSINE_FLOOR``); 65,536 ``corpus_gen``
   transcripts (2,048 episodes x 32 chunks) written to a
   ``LocalTranscriptStore`` and ingested through the port's MCP server
   and client (``ProcessTranscriptsToEmbeddings``, trained embedder on
   the card): the stored vectors equal the bi-encoder's outputs,
   ``SearchIndex`` equals the f32 exact top-10 (reranked: the plain
   fidelity composition) with the scan kernel's launches counted, and
   recall@10 of paraphrases is printed; ``create_server`` over that
   index configured by env for the trained embedder and the
   cross-encoder: /search with text, /rerank "classical" with 100
   documents (the cross-encoder on every 32-pair batch, no fallback,
   the order of the plain f32 composition within the tolerance),
   /search_rerank "auto" (gather launches counted); then texts/s and
   pairs/s (shipped and default geometry) from CUDA events, the host's
   tokenization, the idle share and a ``torch.profiler`` split, each
   beside its FLOP bound;
8. training at the shipped recipes' width (no kernel of ``csrc/`` lies
   on it): the cross-encoder's listwise fine-tune
   (``rerank_eval.train_cross_encoder``, Q=64: 4,096 pairs x 224 tokens
   a step, warm-started from ``artifacts/bi_encoder``, AdamW, bf16) for
   20 steps, and the bi-encoder's InfoNCE
   (``recall_eval.train_bi_encoder``, 128 + 128 texts) for 50, each
   held to (a) the CPU's f32 step from one state and batch (loss rtol
   1e-4, gradients within 1e-3 of their largest entry), (b) the
   CPU-fixed bf16 bounds against the card's f32 step, (c) finite losses,
   moved parameters and finite gates, and for the cross-encoder (d) the
   trained scorer saved and loaded through ``from_config`` scoring 100
   pairs as the live module; then ``train_cli --remat`` for 40 steps
   and ``--resume`` for 20 (its weights rerank through
   ``ClassicalReranker``) and 10 steps of ``distill`` with both
   artifacts; step ms (CUDA events, median of steps 5-20), pairs/s and
   texts/s, peak memory, the FLOP bound, a ``torch.profiler`` split
   (the backward's kernels by the forward part that made them, the
   optimizer apart), the idle share and held-out nDCG@10 beside the
   warm start's.

9. the small-batch accelerator, the native host store and the full
   quantum paths (``accel_quantum_path``; no kernel of ``csrc/`` lies on
   the accelerator's or the statevector's path): (a) 1,048,576 x 768
   f32 unit rows of ``bench.py``'s clustered recipe (256 centers, spread
   0.25/sqrt(d)) in an index with ``small_batch_accel="clustered"``
   (L=512, S=auto), its build timed; every ``index.search`` at B = 1, 4,
   8, 16 (k=10) and B=1 (k=100), and the op at B = 32, 64, equal to the
   f32 oracle (``_check_exact``), escalations and fallbacks counted;
   then per B the accelerator against the same index on the bounded
   path, its group read beside the bound, a ``torch.profiler`` idle
   share at B=1 and the crossover; (b) the same over 1,048,576 uniform
   unit rows, where every batch takes the ladder and stays exact; (c)
   ``clustered_probe`` recall@10 at budgets 8, 20, 80; (d)
   ``/search_rerank`` B=1 candidates=100 through ``create_server`` with
   the accelerator: candidates equal the bounded engine's, ``/stats``
   carries its counters; (f) the fused rerank B=64 C=100 with the full
   statevector at n_qubits 4, 10, 16 against the analytic path (same
   top-10 but for ties within 1e-5, fidelities within 1e-5),
   ``fidelity_statevector`` against numpy complex128, ``/rerank`` of 100
   documents with ``encoding="amplitude"`` against its f64 value, the
   times beside the analytic path's; (e) a 200,000 x 256 native host
   store: ``scan_topk`` and ``cluster_topk`` give one identity and
   ``to_device_index().search`` on the card equals it; host ms.  The
   kernels line gives each kernel's launches on the accelerator's and
   the statevector's runs.

10. the selection modes, the quantized fused rerank and sharded
   retrieval (``modes_sharded_path``) over phase 5's 1,000,000 unit
   rows: (a) ``index.search`` in "approx", "verified", "refined" (and
   "bounded" beside them) at B=1024 k=10 and B=1 k=100 against the f32
   oracle — verified under the exactness contract, the others by
   recall@k >= 0.99 and the returned values within 1e-4 of the oracle's
   — with ``fallback_rows``, ms and the scan_topk kernel's launches a
   call (one: f32, or bf16 for refined); (d) ``/search_rerank`` B=1
   C=100 (quantum, classical, auto) on a quantized index with a bf16
   store, equal bit for bit to an unquantized bf16-store engine's in
   "approx"; (b) a 1 x 4 mesh of slots on this card, bounded: identity
   and tie order against the oracle at both cells, allgather equal to
   ring bit for bit, the summed counters, the packed window scan on
   every shard, the sharded ``search_rerank`` (three rerankers) equal to
   the unsharded engine's within 1e-5, ``/search`` and
   ``/search_rerank`` through ``create_server`` on an engine configured
   by ``--sharded``, the per-shard accelerator at B=1; (c) an elastic
   index on four slots that evicts exactly the slot with an injected
   persistent failure and gives the same B=64 results over three.  The
   kernels line gives K7's launches on the modes path
   (``launches_modes_path``) and every kernel's on the sharded path
   (``launches_sharded_path``).

The last line is the JSON result; the line before it lists the kernels,
the line before that the card.  ``python3 chip_smoke.py --only
gather_vs_twin,scan_topk_vs_twin`` (or ``--only accel_quantum_path``
for phase 9, ``--only modes_sharded_path`` for phase 10) runs the build
and the named phases alone and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

WINDOW = 128
CAP_1M = 1_250_176  # engine capacity for 1,000,000 rows (25% headroom)
# one H100 SXM (NVIDIA's data sheet, dense): device memory rate and
# tensor-core peaks, for the kernels' bounds
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
INT8_OPS_S = 1979e12
FP32_FLOPS_S = 67e12  # FFMA, outside the tensor cores


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
        self.kernel_rows = {}  # (domain, planes, B) -> timing/bound row

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
        # registers and spills of every kernel, by name; and what ptxas
        # says of the wgmma pipelines (C7517 and its kin: a wait it had
        # to put in)
        log = (_build.build_log or "").splitlines()
        for line in log:
            entry = re.search(r"Compiling entry function '\w*\d([a-z][a-z_0-9]*_kernel)(I\w+?EE)?", line)
            if entry:
                print("  ptxas:", entry.group(1), entry.group(2) or "")
            elif any(word in line for word in ("registers", "spill", "wgmma", "warpgroup", "C75")):
                print("  ptxas:", line.strip())
        if log and not any("C75" in line or "warpgroup" in line for line in log):
            print("  ptxas: no C75xx note (it put no wait into a wgmma pipeline)")

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

    def _compare(self, q, x, alpha, ra, ca, planes, dyadic, arm=None):
        """Kernel vs plain twin.  Dyadic: bit-equal planes.  Random: the
        plane contract (``scan_ab.plane_contract``) — upper value bounds
        to rtol 1e-4 / atol 1e-3, lanes equal where the trunc keys agree
        (up to truncated ties).  ``arm`` forces one arm through the CUDA
        wrapper.  Returns (max |upper-bound difference|, keys equal,
        keys, the kernel's planes)."""
        torch = self.torch
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.cuda.scan_ab import plane_contract
        from qrag_tpu_torch.ops.window_scan import make_lane_rank

        lr = make_lane_rank(x.shape[0], self.dev)
        if arm is None:
            got = fused_scan.packed_window_scan(q, x, lr, ra, ca, alpha, planes)
        else:
            got = fused_scan.packed_window_scan_cuda(q, x, ra, ca, alpha, planes, arm)
        torch.cuda.synchronize()
        ref = _float_twin(planes)(q, x, lr, ra, ca, alpha)
        torch.cuda.synchronize()
        if dyadic:
            if not all(torch.equal(g_, r) for g_, r in zip(got, ref)):
                raise AssertionError("dyadic planes differ from the twin")
            return 0.0, 0, 0, got
        err, n_same, n_all, ties = plane_contract(got, ref, q, x, alpha, ra, ca)
        self.lane_ties = getattr(self, "lane_ties", 0) + ties
        return err, n_same, n_all, got

    def kernel_vs_twin(self):
        """The float domain against its twins: the first form's grid of
        cases, B on both sides of the cut between the arms, a ragged
        last query tile (257, 1000) and window pair (N=4224: 33
        windows), d = 64, 128, 768; then each arm forced on shapes both
        take and held against the twin and against the other."""
        torch = self.torch
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.cuda.scan_ab import plane_contract

        cut = fused_scan.WIDE_MIN_B[False]
        fused_scan.reset_launches()
        n_cases = 0
        for n in (4096, 4224, CAP_1M):
            small = n != CAP_1M
            batches = sorted({1, 7, cut - 1, cut, 64, 128, 256, 257, 1000, 1024}) if small \
                else (1, 7, 64, 257, 1024)
            for d in (64, 128, 768) if small else (128, 768):
                err, n_same, n_all = 0.0, 0, 0
                for b in batches:
                    for planes in (1, 2, 3):
                        for metric in ("ip", "l2"):
                            for dyadic in (True, False):
                                inp = self._scan_inputs(
                                    b, n, d, metric, dyadic, seed=n + d + b
                                )
                                e, s_, a_, _ = self._compare(*inp, planes, dyadic)
                                err, n_same, n_all = max(err, e), n_same + s_, n_all + a_
                                n_cases += 1
                                del inp
                # tensor-core f32 accumulation moves a score across a
                # truncation boundary more often than IEEE order does
                # (one quantum at most on random data); the value bounds
                # above are the binding check, as for the reference's
                # transposed kernel (>= 90% of keys there)
                share = n_same / n_all
                print(f"kernel vs twin: N={n} d={d} B={','.join(map(str, batches))} "
                      f"planes=1,2,3 ip,l2 dyadic+random: ok (random: max |hi err| "
                      f"{err:.3g}, trunc keys equal {share:.4f})", flush=True)
                if share < 0.9:
                    raise AssertionError(f"only {share:.4f} of trunc keys agree")
        for b, n, d in ((7, 4224, 128), (64, 4096, 768), (300, 4224, 768), (1000, 4224, 64)):
            for planes in (1, 2, 3):
                for dyadic in (True, False):
                    inp = self._scan_inputs(b, n, d, "l2", dyadic, seed=b + planes)
                    got = {arm: self._compare(*inp, planes, dyadic, arm=arm)[3]
                           for arm in ("general", "wide")}
                    if dyadic:
                        if not all(torch.equal(g_, w) for g_, w in
                                   zip(got["general"], got["wide"])):
                            raise AssertionError("dyadic planes differ between the arms")
                    else:
                        plane_contract(got["wide"], got["general"], *inp)
                    n_cases += 2
                    del inp, got
        arms = dict(fused_scan.arm_launches)
        if not all(arms.values()):
            raise AssertionError(f"an arm of the float domain was never launched: {arms}")
        self.torch.cuda.empty_cache()
        print(f"kernel vs twin: {n_cases} cases ok, launches per arm {arms}, each arm "
              f"forced on 4 shapes and held against the other (lanes differing at "
              f"truncated ties: {getattr(self, 'lane_ties', 0)})")

    def int8_vs_twin(self):
        """The int8 domain against its twins: bit-equal on every input,
        whichever arm runs, and arm against arm."""
        torch = self.torch
        from qrag_tpu_torch.ops import bounded_topk as bt
        from qrag_tpu_torch.ops import window_scan as ws
        from qrag_tpu_torch.ops.cuda import fused_scan

        gen = torch.Generator(device=self.dev).manual_seed(0)
        cut = fused_scan.WIDE_MIN_B[True]
        fused_scan.reset_launches()
        n_cases = 0
        small = tuple(sorted({1, 7, cut - 1, cut, 64, 128, 256, 257, 1000, 1024}))
        groups = [(n, d, small if n != CAP_1M else (1, 7, 64, 257, 1024))
                  for n in (4096, 4224, CAP_1M) for d in (16, 64, 128, 768)
                  if n != CAP_1M or d != 64]
        groups.append((4096, 8192, (1, 7, 64)))  # keys clip at 2^23
        for n, d, batches in groups:
            x = torch.randint(-127, 128, (n, d), generator=gen, device=self.dev,
                              dtype=torch.int8)
            if d == 8192:
                x = torch.where(x >= 0, 127, -127).to(torch.int8)
            lr = ws.make_lane_rank(n, self.dev)
            clipped = 0
            for b in batches:
                q = torch.randint(-127, 128, (b, d), generator=gen, device=self.dev,
                                  dtype=torch.int8)
                if d == 8192:
                    q = torch.where(q >= 0, 127, -127).to(torch.int8)
                    q[0] = x[5]  # aligned pair: dot = d * 127^2 >> 2^23
                refs = {1: (ws.packed_window_scan(q, x, lr),),
                        2: bt.packed_window_scan_top2_int(q, x, lr)}
                # the planned arm, then every arm that takes the shape
                arms = [None, "general"] + (["wide"] if d % 128 == 0 else [])
                for planes, ref in refs.items():
                    for arm in arms if n != CAP_1M else arms[:1]:
                        got = (fused_scan.packed_window_scan(q, x, None, planes=planes)
                               if arm is None else
                               fused_scan.packed_window_scan_cuda(q, x, planes=planes, arm=arm))
                        torch.cuda.synchronize()
                        if len(got) != planes or not all(
                            torch.equal(g_, r) for g_, r in zip(got, ref)
                        ):
                            raise AssertionError(
                                f"int8 planes={planes} N={n} d={d} B={b} arm={arm} "
                                "differ from the twin"
                            )
                        n_cases += 1
                clipped += int(((refs[2][0] >> 7).abs() >= (1 << 23) - 1).sum())
            print(f"kernel vs twin int8: N={n} d={d} B={','.join(map(str, batches))} "
                  f"planes=1,2: bit-equal (clipped top keys: {clipped})", flush=True)
            if d == 8192 and not clipped:
                raise AssertionError("the clip case clipped no key")
            del x
        arms = dict(fused_scan.arm_launches)
        if not all(arms.values()):
            raise AssertionError(f"an arm of the int8 domain was never launched: {arms}")
        self.torch.cuda.empty_cache()
        print(f"kernel vs twin int8: {n_cases} cases bit-equal, launches per arm {arms}")

    def gather_vs_twin(self):
        """The row-gather kernel against plain_gather_rows: bit-equal."""
        torch = self.torch
        from qrag_tpu_torch.ops import gather_rows as tg

        gen = torch.Generator(device=self.dev).manual_seed(0)
        n_cases = 0
        for d in (768, 100):
            base = torch.randn((200_000, d), generator=gen, device=self.dev)
            for dtype in (torch.float32, torch.bfloat16, torch.int8):
                x = (base * 40).to(dtype) if dtype == torch.int8 else base.to(dtype)
                for m in (1, 100, 6400, 102400):
                    for it in (torch.int32, torch.int64):
                        # clamped at both ends: out-of-range and negative rows
                        idx = torch.randint(-1000, 201_000, (m,), generator=gen,
                                            device=self.dev).to(it)
                        got = tg.gather_rows(x, idx)
                        torch.cuda.synchronize()
                        if not torch.equal(got, tg.plain_gather_rows(x, idx)):
                            raise AssertionError(f"gather {dtype} d={d} M={m} {it} != twin")
                        n_cases += 1
                del x
            del base
        self._free()
        print(f"kernel vs twin gather: {n_cases} cases bit-equal (f32, bf16, int8 rows; "
              f"d=768, 100; M=1, 100, 6400, 102400; int32 and int64 indices, clamped)")

    def _check_topk(self, got, want, q, x, metric, bf16):
        """scan_topk kernel vs twin under the summation-order tolerance.
        Values agree within rtol 1e-5, except where the score cancels
        (|score| < 1e-2 of its terms' scale, 1 + |q|^2 + |x|^2, e.g. the
        l2 distance of a row to its own copy): two f32 sums of the same
        products differ by a few ulps of the terms, not of the result,
        so there they agree within 1e-5 of that scale.  Indices agree
        except where the kernel's row scores, in f64 from the same
        operands, within 1e-5 of the scale of the twin's slot.  Returns
        (differing index slots, cancelling slots, max relative error
        elsewhere)."""
        torch = self.torch
        (kv, ki), (pv, pi) = got, want
        fin = torch.isfinite(pv)
        if not torch.equal(fin, torch.isfinite(kv)) or not torch.equal(
            (ki < 0), (pi < 0)
        ):
            raise AssertionError("scan_topk: sentinel slots differ from the twin")
        qsq = (q.double() ** 2).sum(1)
        b, t = torch.nonzero(fin, as_tuple=True)
        scale = 1.0 + qsq[b] + (x[pi[b, t].long()].double() ** 2).sum(1)
        ref = pv[b, t].double().abs()
        err = (kv[b, t].double() - pv[b, t].double()).abs()
        cancel = ref < 1e-2 * scale
        rel = torch.where(cancel, 0.0, err / ref.clamp_min(1e-30))
        bad = torch.where(cancel, err > 1e-5 * scale, rel > 1e-5)
        if bool(bad.any()):
            worst = int(torch.nonzero(bad)[0])
            raise AssertionError(
                f"scan_topk values outside the tolerance: err {float(err[worst])} at "
                f"value {float(ref[worst])}, scale {float(scale[worst])}"
            )
        max_rel = float(rel.max()) if rel.numel() else 0.0
        diff = ki != pi
        if bool(diff.any()):
            b, t = torch.nonzero(diff, as_tuple=True)
            rows = ki[b, t].long()
            qq, xx = q[b].double(), x[rows].double()
            if bf16:
                qq, xx = q[b].bfloat16().double(), x[rows].bfloat16().double()
            g = (qq * xx).sum(1)
            xsq = (x[rows].double() ** 2).sum(1)
            if metric == "l2":
                g = qsq[b] + xsq - 2 * g
            if not bool(((g - pv[b, t].double()).abs() <= 1e-5 * (1 + qsq[b] + xsq)).all()):
                raise AssertionError("scan_topk indices differ beyond a near-tie")
        return int(diff.sum()), int(cancel.sum()), max_rel

    def _scan_topk_arm(self, q, x, k, metric, sq, vr, cd, arm):
        """scan_topk with one arm of the kernel forced: the entry
        point's own steps around the CUDA wrapper, which alone takes an
        arm."""
        from qrag_tpu_torch.ops import scan_topk as ts
        from qrag_tpu_torch.ops.cuda import scan_topk as ct

        ops = ts._prepare(q, x, k, metric, sq, vr, cd)
        vals, idx = ct.scan_topk_cuda(*ops, k, metric == "l2", cd == self.torch.bfloat16, arm)
        return ts._finalize(vals, idx, metric)

    def _topk_case(self, q, x, k, metric, cd, vr, tally, arm=None):
        """One scan_topk call against its twin; adds to ``tally``
        [cases, differing slots, slots, cancelling slots, max rel]."""
        torch = self.torch
        from qrag_tpu_torch.ops import scan_topk as ts

        if arm is None:
            got = ts.scan_topk(q, x, k, metric, valid_rows=vr, compute_dtype=cd)
        else:
            got = self._scan_topk_arm(q, x, k, metric, None, vr, cd, arm)
        torch.cuda.synchronize()
        want = ts.plain_scan_topk(q, x, k, metric, valid_rows=vr, compute_dtype=cd)
        nd, nc, mr = self._check_topk(got, want, q, x, metric, cd == torch.bfloat16)
        tally[0] += 1
        tally[1] += nd
        tally[2] += q.shape[0] * k
        tally[3] += nc
        tally[4] = max(tally[4], mr)

    def scan_topk_vs_twin(self):
        """The scan_topk kernel (every arm, f32 and bf16 compute) against
        its twin: the first form's grid of cases, then the shapes at
        which the arms, tiles and buffers cut."""
        torch = self.torch
        from qrag_tpu_torch.ops.cuda import scan_topk as ct

        gen = torch.Generator(device=self.dev).manual_seed(1)
        x = torch.randn((100_000, 768), generator=gen, device=self.dev)
        x[7::1000] = x[3]  # planted duplicate rows: ties to the lower index
        for r in (63, 64, 127, 128, 255, 256):  # and across every tile boundary
            x[r] = x[3]
        valid = torch.rand(100_000, generator=gen, device=self.dev) > 0.1
        valid[2048:3072] = False  # whole tiles of every arm masked
        both = (torch.float32, torch.bfloat16)
        tally = [0, 0, 0, 0, 0.0]
        ct.reset_launches()
        for b in (1, 7, 64, 1024):
            q = torch.randn((b, 768), generator=gen, device=self.dev)
            q[0] = x[3]
            for k in (1, 10, 100, 129, 1000):
                for metric in ("l2", "ip"):
                    for cd in both:
                        for vr in (None, valid):
                            self._topk_case(q, x, k, metric, cd, vr, tally)
        # B on both sides of the arms' cuts (bf16: stream <= 8 < wgmma64
        # <= 64 < wgmma128; f32: stream <= 64 < tiled), the stream arm
        # and the general arm forced past their cuts
        for b in (8, 9, 33, 64, 65):
            q = torch.randn((b, 768), generator=gen, device=self.dev)
            q[0] = x[3]
            for metric in ("l2", "ip"):
                for cd in both:
                    for vr in (None, valid):
                        self._topk_case(q, x, 10, metric, cd, vr, tally)
            if b in (9, 33):
                for cd in both:
                    for arm in ("stream", "general"):
                        self._topk_case(q, x, 10, "l2", cd, valid, tally, arm=arm)
        # k on both sides of every buffer and tile cut
        for b, ks in ((1, (256, 257, 768, 769, 1024)), (7, (256, 257)),
                      (1024, (24, 25, 64, 65))):
            q = torch.randn((b, 768), generator=gen, device=self.dev)
            q[0] = x[3]
            for k in ks:
                for cd in both:
                    self._topk_case(q, x, k, "l2", cd, valid, tally)
        q = torch.randn((200, 768), generator=gen, device=self.dev)
        for k in (10, 50):  # fewer rows than one tile of any arm; k = N
            for b in (1, 64, 200):
                for cd in both:
                    self._topk_case(q[:b], x[:50], k, "ip", cd, valid[:50], tally)
        del x
        # rows that are not 16-byte aligned (d = 13) and a depth that is
        # no multiple of a tile's (d = 100); N no multiple of any tile
        for d in (100, 13):
            x = torch.randn((5000, d), generator=gen, device=self.dev)
            x[255], x[256] = x[3], x[3]
            for b in (1, 7, 9, 64, 200):
                q = torch.randn((b, d), generator=gen, device=self.dev)
                q[0] = x[3]
                for k in (10, 100):
                    for metric in ("l2", "ip"):
                        for cd in both:
                            self._topk_case(q, x, k, metric, cd, valid[:5000], tally)
        del valid
        self._free()
        arms = dict(ct.arm_launches)
        if min(arms.values()) < 1:
            raise AssertionError(f"scan_topk: an arm was never reached: {arms}")
        n_cases, n_diff, n_slots, n_cancel, max_rel = tally
        print(f"kernel vs twin scan_topk: {n_cases} cases ok, launches by arm {arms} "
              f"(N=100000 d=768: B=1,7,64,1024 x k=1,10,100,129,1000 x l2+ip x f32+bf16 x "
              f"valid_rows or not; B=8,9,33,64,65 at k=10, the stream and general arms forced at B=9,33; "
              f"k=256,257,768,769,1024 at B=1, 256,257 at B=7, 24,25,64,65 at B=1024; "
              f"N=50 at k=10,50; N=5000 d=100,13 at B=1,7,9,64,200; planted duplicates "
              f"across tile boundaries, whole tiles masked); values within rtol 1e-5 "
              f"(max {max_rel:.3g}), except {n_cancel} cancelling slots within "
              f"1e-5 * (1 + |q|^2 + |x|^2); {n_diff} of {n_slots} index slots differ, "
              f"all at near-ties (within 1e-5 * (1 + |q|^2 + |x|^2))")

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

    def _bounded_int8_case(self, name, q, x, metric, k, valid=None, expect=None,
                           atol=1e-4, **kw):
        """bounded_exact_topk_int8 through the kernel (int8 scan, f32
        refine) against the f32 oracle."""
        torch = self.torch
        from qrag_tpu_torch.ops import bounded_topk as bt
        from qrag_tpu_torch.ops import window_scan as ws
        from qrag_tpu_torch.ops.topk import _goodness

        qt = torch.from_numpy(q).to(self.dev)
        xt = torch.from_numpy(x).to(self.dev)
        vt = None if valid is None else torch.from_numpy(valid).to(self.dev)
        sq = (xt * xt).sum(1)
        q8x, sc = ws.quantize_block_rows_device(xt)
        q8x = ws.pad_cols(q8x, -(-x.shape[1] // 16) * 16).contiguous()
        vals, idx, fb, npatch, esc = bt.bounded_exact_topk_int8(
            qt, q8x, sc, xt, sq, bt.window_maxnorms_device(sq),
            bt.window_minsqnorms_device(sq),
            bt.window_quant_residuals_device(xt, q8x, sc),
            ws.make_lane_rank(x.shape[0], self.dev), k, metric=metric,
            valid_rows=vt, **kw,
        )
        ov, oi = bt._exact_full_sort(qt, xt, sq, k, metric, vt)
        g = _goodness(qt, xt, metric, sq, vt)
        ties = _check_exact(idx, vals, oi, ov, g, atol=atol)
        if expect is not None and (fb, esc) != expect:
            raise AssertionError(f"{name}: (fell_back, escalated) {(fb, esc)} != {expect}")
        print(f"exact int8: {name}: ok (fell_back={fb} escalated={esc} "
              f"patched={int(npatch)} sub-noise tie reorders={ties})", flush=True)

    def _own_case(self, name, q, x, metric, k, valid=None, check=None, **kw):
        """exact_topk_int8_domain through the kernel against a numpy
        own-domain oracle built from the op's own rounded query."""
        torch = self.torch
        from qrag_tpu_torch.ops import int8_domain as i8
        from qrag_tpu_torch.ops import window_scan as ws

        qt = torch.from_numpy(q).to(self.dev)
        x8, sc = ws.quantize_block_rows_device(torch.from_numpy(x).to(self.dev))
        x8 = ws.pad_cols(x8, -(-x.shape[1] // 16) * 16).contiguous()
        isq = i8.row_int_sqnorms(x8)
        vt = None if valid is None else torch.from_numpy(valid).to(self.dev)
        vals, idx, fb, npatch, esc = i8.exact_topk_int8_domain(
            qt, x8, sc, isq, ws.make_lane_rank(x.shape[0], self.dev), k,
            metric=metric, valid_rows=vt, **kw,
        )
        q8, t = i8.quantize_query_int8(qt)
        ov, oi, g = _own_oracle(q8, t, x8[:, : x.shape[1]], sc, isq, k, metric, valid)
        _check_own(idx.cpu().numpy(), vals.cpu().numpy(), oi, ov, g)
        if check is not None and not check(fb, npatch, esc):
            raise AssertionError(f"{name}: flags fell_back={fb} escalated={esc} patched={int(npatch)}")
        print(f"exact own-domain int8: {name}: ok (fell_back={fb} escalated={esc} "
              f"patched={int(npatch)})", flush=True)

    def exactness_int8(self):
        """The planted corpora of tests/test_bounded_int8.py and
        tests/test_int8_domain.py through the int8 arm."""
        W = WINDOW

        def unit(a):
            return a / np.linalg.norm(a, axis=1, keepdims=True)

        for metric in ("ip", "l2"):
            rng = np.random.RandomState(0)
            x = unit(rng.randn(131072, 64).astype(np.float32))
            q = rng.randn(8, 64).astype(np.float32)
            self._bounded_int8_case(f"random 131072x64 {metric}", q, x, metric, 10)
            rng = np.random.RandomState(1)
            x = unit(rng.randn(32768, 128).astype(np.float32))
            q = unit(rng.randn(6, 128).astype(np.float32))
            for j in range(24):
                x[W * (9 * j + 3) + (j % W)] = q[0] * (1.0 - 2e-3 * j)
            self._bounded_int8_case(f"near-boundary {metric}", q, x, metric, 10, atol=5e-3)
        rng = np.random.RandomState(2)
        x = rng.randn(16384, 32).astype(np.float32)
        x *= np.exp(rng.randn(16384, 1)).astype(np.float32)
        self._bounded_int8_case("lognormal norms l2", rng.randn(4, 32).astype(np.float32),
                                x, "l2", 8, atol=1e-2)
        x = 0.05 * rng.randn(16384, 32).astype(np.float32)
        q = rng.randn(4, 32).astype(np.float32)
        t = q[0] / np.linalg.norm(q[0])
        for j, off in enumerate((3, 40, 100)):
            x[23 * W + off] = t * (4.0 + 0.01 * j)
        self._bounded_int8_case("window collision ip", q, x, "ip", 8)
        for count, stride, expect in ((20, 2, (False, True)), (40, 1, (True, True))):
            rng = np.random.RandomState(3)
            x = rng.randn(8192, 16).astype(np.float32)
            q = rng.randn(4, 16).astype(np.float32)
            t = q[0] / np.linalg.norm(q[0])
            for j in range(count):
                x[j * W * stride + 5] = t * (5.0 + 1e-6 * j)
            self._bounded_int8_case(f"{count} tied windows, C=8", q, x, "ip", 6,
                                    expect=expect, candidates=8)
        rng = np.random.RandomState(4)
        x = np.sign(rng.randn(4096, 8192)).astype(np.float32)
        q = np.sign(rng.randn(2, 8192)).astype(np.float32)
        q[0] = x[5]
        self._bounded_int8_case("clipped keys d=8192", q, x, "ip", 5,
                                expect=(True, False), atol=1e-1)
        rng = np.random.RandomState(5)
        x = np.abs(rng.randn(4096, 32)).astype(np.float32)
        q = -np.abs(rng.randn(4, 32)).astype(np.float32)
        valid = np.ones(4096, bool)
        valid[-300:] = False
        x[-300:] = 0.0
        self._bounded_int8_case("valid rows + padding windows ip", q, x, "ip", 5, valid=valid)

        for metric in ("l2", "ip"):
            rng = np.random.default_rng(0)
            x = unit(rng.standard_normal((65536, 128), np.float32))
            q = rng.standard_normal((8, 128), np.float32)
            self._own_case(f"random 65536x128 {metric}", q, x, metric, 10,
                           check=lambda fb, p, e: not fb)
            rng = np.random.default_rng(1)
            x = np.tile(rng.standard_normal((16, 64), np.float32), (128, 1))
            q = rng.standard_normal((4, 64), np.float32)
            self._own_case(f"tiled duplicates {metric}", q, x, metric, 10,
                           check=lambda fb, p, e: fb or e, candidates=16)
        rng = np.random.default_rng(2)
        x = rng.standard_normal((8192, 128), np.float32)
        x /= 10.0 * np.linalg.norm(x, axis=1, keepdims=True)
        q = rng.standard_normal((2, 128), np.float32)
        x[130] = q[0] / np.linalg.norm(q[0])
        x[131] = x[130] * 0.999
        self._own_case("window collision", q, x, "ip", 5,
                       check=lambda fb, p, e: not fb and int(p) >= 1)
        rng = np.random.default_rng(3)
        q = np.abs(rng.standard_normal((4, 128)).astype(np.float32))
        x = -np.abs(rng.standard_normal((16384, 128)).astype(np.float32))
        x[15000:] = 0.0
        valid = np.arange(16384) < 15000
        for metric in ("ip", "l2"):
            self._own_case(f"valid rows, negative corpus {metric}", q, x, metric, 10,
                           valid=valid)
        rng = np.random.default_rng(4)
        self._own_case("single query", rng.standard_normal((1, 128), np.float32),
                       rng.standard_normal((16384, 128), np.float32), "l2", 10)
        x = np.ones((1024, 768), np.float32)
        x[:, 0] += np.arange(1024, dtype=np.float32) / 1024
        self._own_case("clipped keys d=768", np.ones((2, 768), np.float32), x, "ip", 5,
                       check=lambda fb, p, e: fb)

    # -------------------------------------------------------------- phase 5

    def main_path(self, n_rows=1_000_000):
        """The three main paths over one host corpus of unit rows, one
        engine at a time: the default config, (a) the int8 bounded scan,
        (b) the quantized index.  Returns the kernel launch counts of
        the paths' runs."""
        rng = np.random.default_rng(0)
        x = rng.standard_normal((n_rows, 768), dtype=np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        launches = self.default_path(x)
        self._free()
        launches.update(self.bounded_int8_path(x))
        self._free()
        launches.update(self.quantized_path(x))
        self._free()
        return launches

    def _free(self):
        gc.collect()
        self.torch.cuda.empty_cache()

    def _engine(self, x, label, index_over=None):
        """An engine over ``x`` (hash embedder, d=768) with derived
        buffers and first launches made by a B=1 warmup."""
        torch = self.torch
        from qrag_tpu_torch.config import QragConfig
        from qrag_tpu_torch.engine import QragEngine

        t0 = time.perf_counter()
        over = {"embedding": {"provider": "hash", "dim": 768}}
        if index_over:
            over["index"] = index_over
        engine = QragEngine(config=QragConfig.from_dict(over), device=self.dev)
        engine.index.add(x)
        snap = engine.index.device_buffers()
        # the quantized window index pads capacity to 1024-row multiples
        cap = CAP_1M if not index_over or "quantization" not in index_over else 1_251_328
        if x.shape[0] == 1_000_000 and snap.matrix.shape != (cap, 768):
            raise AssertionError(f"capacity {tuple(snap.matrix.shape)}")
        warm = engine.warmup(batch_sizes=(1,))
        print(f"{label}: {x.shape[0]:,} x 768 rows on {self.dev}, "
              f"{snap.matrix.dtype} store, capacity {snap.matrix.shape[0]}; "
              f"setup {time.perf_counter() - t0:.1f} s (warmup {warm:.2f} s); "
              f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        return engine, snap

    @contextlib.contextmanager
    def _serve(self, engine, batching=False):
        from qrag_tpu_torch.serving.http_app import create_server

        kw = {"max_wait_s": 0.005} if batching else {}
        server = create_server(engine, "127.0.0.1", 0, batching=batching, **kw)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            yield server.server_address[1]
        finally:
            server.shutdown()
            server.server_close()
            if server.batcher is not None:
                server.batcher.close()
            thread.join(timeout=30)

    def _unit(self, seed):
        qrng = np.random.default_rng(seed)

        def unit(b):
            q = qrng.standard_normal((b, 768), dtype=np.float32)
            return q / np.linalg.norm(q, axis=1, keepdims=True)

        return unit

    def _oracle(self, snap, q, k):
        """f32 top-k of the stored rows (the refine domain)."""
        from qrag_tpu_torch.ops import bounded_topk as bt

        qt = self.torch.from_numpy(q).to(self.dev)
        v, i = bt._exact_full_sort(qt, snap.matrix, snap.sqnorms, k, "l2", snap.valid)
        return qt, v, i

    def _check_search(self, snap, pairs):
        """/search responses against the f32 oracle under the repo's
        exactness contract; returns the tie reorders."""
        torch = self.torch
        from qrag_tpu_torch.ops.topk import _goodness

        ties = 0
        for q, resp in pairs:
            qt, ov, oi = self._oracle(snap, q, 10)
            got = np.asarray([[h["index"] for h in r] for r in resp["results"]])
            dist = np.asarray([[h["score"] for h in r] for r in resp["results"]])
            g = _goodness(qt, snap.matrix, "l2", snap.sqnorms, snap.valid)
            ties += _check_exact(
                torch.from_numpy(got).to(self.dev), -torch.from_numpy(dist).to(self.dev),
                oi, ov, g, atol=1e-4,
            )
        return ties

    def _check_rerank(self, snap, pairs):
        """/search_rerank responses against the plain composition: the
        oracle top-100 -> rotation_features -> fidelity -> stable top-10."""
        from qrag_tpu_torch.ops.statevector import (
            fidelity_from_features,
            rotation_features,
        )
        from qrag_tpu_torch.ops.topk import top_k

        for q, resp in pairs:
            qt, _, cand = self._oracle(snap, q, 100)
            feats = rotation_features(snap.matrix[cand].float(), 4, snap.sqnorms[cand])
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

    def _launched(self, keys, label):
        from qrag_tpu_torch.ops.cuda import fused_scan

        launches, arms = dict(fused_scan.launches), dict(fused_scan.arm_launches)
        print(f"{label} launches: {launches}; per arm: {arms}")
        missed = [key for key in keys if launches[key] < 1]
        if missed:
            raise AssertionError(f"{label}: kernel not launched for {missed}: {launches}")
        if sum(arms.values()) != sum(launches.values()):
            raise AssertionError(f"{label}: arm counts {arms} vs launches {launches}")
        return {key: launches[key] for key in keys}

    def _arm_of(self, fn, calls=1):
        """Runs ``fn`` and names the arm of the scan kernel whose launch
        count rose by ``calls``; fails if none or several did."""
        from qrag_tpu_torch.ops.cuda import fused_scan

        before = dict(fused_scan.arm_launches)
        fn()
        rose = {a: c - before[a] for a, c in fused_scan.arm_launches.items() if c != before[a]}
        if len(rose) != 1 or list(rose.values()) != [calls]:
            raise AssertionError(f"expected {calls} launches of one arm, counted {rose}")
        return next(iter(rose))

    def default_path(self, x):
        """The default-config engine (bf16 bounded scan, f32 store)."""
        from qrag_tpu_torch.ops.cuda import fused_scan

        engine, snap = self._engine(x, "main path")
        warm_counts = (
            f"escalations={engine.index.bounded_escalations} "
            f"fallbacks={engine.index.fallback_rows}"
        )
        unit = self._unit(1)
        q1, q64, r1, r16 = unit(1), unit(64), unit(1), unit(16)
        with self._serve(engine) as port:
            fused_scan.reset_launches()
            s1 = _post(port, "/search", {"vectors": q1.tolist(), "k": 10})
            s64 = _post(port, "/search", {"vectors": q64.tolist(), "k": 10})
            st = _post(port, "/search", {"query": "find the advertisement", "k": 10})
            rr1 = _post(port, "/search_rerank", {"vectors": r1.tolist(), "k": 10, "candidates": 100})
            rr16 = _post(port, "/search_rerank", {"vectors": r16.tolist(), "k": 10, "candidates": 100})
            stats = _get(port, "/stats")
            launches = self._launched([("bf16", 2), ("bf16", 3)], "main path")
            qtext = engine.embedder(["find the advertisement"])
            ties = self._check_search(snap, ((q1, s1), (q64, s64), (qtext, st)))
            print(f"/search B=1, B=64, text: indices equal the f32 oracle "
                  f"(sub-noise tie reorders: {ties})")
            self._check_rerank(snap, ((r1, rr1), (r16, rr16)))
            print("/search_rerank B=1, B=16 (k=10, candidates=100): equal to the "
                  "oracle top-100 -> rotation_features -> fidelity -> stable top-10")
            idx_stats = stats["index"]
            print(f"/stats: bounded_escalations={idx_stats['bounded_escalations']} "
                  f"fallback_rows={idx_stats['verified_fallback_rows']} "
                  f"(of which warmup's all-zero query: {warm_counts}) "
                  f"effective_topk_modes={idx_stats['effective_topk_modes']} "
                  f"backend={stats['backend']} devices={stats['devices']}")
            self.timings(engine, port, unit)
        launches.update(self.routed_path(engine, snap))
        self.gather_timings(snap)
        self.scan_topk_timings(snap, unit)
        return launches

    def _routed_want(self, snap, qv, route, k=10):
        """The plain composition of the routed rerank: f32 exact top-100
        -> gather by indexing -> fidelity on the raw rows or cosine ->
        stable top-k."""
        torch = self.torch
        from qrag_tpu_torch.ops.statevector import fidelity_analytic
        from qrag_tpu_torch.ops.topk import top_k

        qt, _, cand = self._oracle(snap, np.ascontiguousarray(qv, np.float32), 100)
        rows = snap.matrix[cand.long()].float()
        fid = fidelity_analytic(qt[:, None, :], rows, 4)
        qn = qt / qt.norm(dim=1, keepdim=True).clamp_min(1e-12)
        cn = rows / rows.norm(dim=2, keepdim=True).clamp_min(1e-12)
        cos = (cn * qn[:, None, :]).sum(2)
        r = torch.tensor(route, device=self.dev)[:, None]
        v, sel = top_k(torch.where(r, fid, cos), k)
        return cand.gather(1, sel).cpu().numpy(), v.cpu().numpy()

    def _check_routed(self, snap, qv, route, resp, used):
        want_i, want_s = self._routed_want(snap, qv, route)
        got = np.asarray([[h["index"] for h in r] for r in resp["results"]])
        score = np.asarray([[h["score"] for h in r] for r in resp["results"]])
        if not np.array_equal(got, want_i):
            raise AssertionError(f"routed /search_rerank differs from the plain "
                                 f"composition:\n{got}\n{want_i}")
        np.testing.assert_allclose(score, want_s, rtol=1e-5, atol=1e-6)
        if resp["reranker_used"] != used:
            raise AssertionError(resp["reranker_used"])

    def _docs_want(self, query, contents, route, top_k):
        """The plain composition of POST /rerank: embed, score (fidelity
        of the mock embeddings or cosine of the hash embeddings), stable
        descending sort."""
        torch = self.torch
        from qrag_tpu_torch.ops.statevector import fidelity_analytic
        from qrag_tpu_torch.ops.topk import cosine_scores
        from qrag_tpu_torch.pipeline.embeddings import HashEmbedder, MockEmbedder

        if route == "quantum":
            e = torch.from_numpy(MockEmbedder(8)([query] + contents)).to(self.dev)
            scores = fidelity_analytic(e[0], e[1:], 4)
        else:  # the classical reranker embeds whitespace-collapsed text
            texts = [" ".join(t.split())[:2048] for t in [query] + contents]
            e = torch.from_numpy(HashEmbedder(256)(texts)).to(self.dev)
            scores = cosine_scores(e[:1], e[1:])[0]
        order = torch.sort(scores, descending=True, stable=True)[1][:top_k].cpu().numpy()
        return [str(i) for i in order], scores.cpu().numpy()[order]

    def _check_docs(self, query, contents, route, resp, top_k):
        ids, scores = self._docs_want(query, contents, route, top_k)
        got = [e["document"]["id"] for e in resp["documents"]]
        if got != ids or resp["reranker_used"] != route:
            raise AssertionError(f"/rerank {route}: {got} != {ids}")
        np.testing.assert_allclose([e["score"] for e in resp["documents"]], scores,
                                   rtol=1e-5, atol=1e-6)

    def routed_path(self, engine, snap):
        """The serving layer on the default engine: routed
        /search_rerank, POST /rerank, and a batching server.  Returns the
        gather kernel's launches of this run."""
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.cuda import gather_rows as cg
        from qrag_tpu_torch.ops.cuda import scan_topk as ct

        ctl = engine.controller
        keyword = [f"find the advertisement segment {i}" for i in range(32)]
        plain = [f"what is the weather on day {i}" for i in range(32)]
        mixed = [t for pair in zip(keyword, plain) for t in pair]  # B=64
        contents = [f"segment {i}: " + ("buy our product " if i % 3 else "the news ") * (1 + i % 5)
                    for i in range(100)]
        docs = [{"id": str(i), "content": c} for i, c in enumerate(contents)]
        unit = self._unit(4)
        vecs = unit(64)
        with self._serve(engine) as port:
            fused_scan.reset_launches()
            cg.reset_launches()
            ct.reset_launches()
            t0 = time.perf_counter()
            runs = [
                (keyword[:1], "auto", "auto"), (plain[:1], "auto", "auto"),
                (mixed, "auto", "auto"), (plain[:1], "classical", "classical"),
                (mixed, "classical", "classical"),
            ]
            resps = [
                _post(port, "/search_rerank", {"queries": t, "k": 10, "candidates": 100,
                                               "reranker_type": rt})
                for t, rt, _ in runs
            ]
            vec_classical = _post(port, "/search_rerank", {
                "vectors": vecs.tolist(), "k": 10, "candidates": 100,
                "reranker_type": "classical"})
            rr_q = _post(port, "/rerank", {"query": keyword[0], "documents": docs, "top_k": 10})
            rr_c = _post(port, "/rerank", {"query": plain[0], "documents": docs, "top_k": 10})
            routed_s = time.perf_counter() - t0
            gather_launches = cg.launches
            scan_launches = dict(fused_scan.launches)
            scan_arms = dict(fused_scan.arm_launches)
            topk_launches = dict(ct.launches)
        print(f"routed path launches: gather_rows {gather_launches}, scan {scan_launches} "
              f"(per arm {scan_arms}), scan_topk {topk_launches} ({routed_s:.2f} s of requests)")
        if gather_launches < 1:
            raise AssertionError("routed path: the gather kernel was not launched")
        # one scan a request: three of one query, three of 64
        want = {"general": 0, "wide": 0}
        for b in (1, 1, 64, 1, 64, 64):
            want["wide" if b >= fused_scan.WIDE_MIN_B[False] else "general"] += 1
        if scan_arms != want:
            raise AssertionError(f"routed path: scan launches per arm {scan_arms}, not {want}")
        for (texts, _, used), resp in zip(runs, resps):
            route = [ctl.select_reranker(t) == "quantum" for t in texts]
            if used == "classical":
                route = [False] * len(texts)
            self._check_routed(snap, engine.embedder(texts), route, resp, used)
        self._check_routed(snap, vecs, [False] * 64, vec_classical, "classical")
        print("routed /search_rerank auto (keyword B=1, plain B=1, mixed B=64) and "
              "classical (B=1, B=64 text; B=64 vectors), k=10 candidates=100: equal to "
              "the oracle top-100 -> gather -> fidelity|cosine -> stable top-10")
        self._check_docs(keyword[0], contents, "quantum", rr_q, 10)
        self._check_docs(plain[0], contents, "classical", rr_c, 10)
        print("POST /rerank 100 documents, quantum and classical routes: equal to the "
              "plain composition (embed -> fidelity|cosine -> stable sort)")
        self.batching_check(engine, unit, keyword, contents)
        self.routed_latency(engine)
        return {"gather_rows": gather_launches,
                **{("scan_topk", arm): n for arm, n in topk_launches.items()}}

    def batching_check(self, engine, unit, keyword, contents):
        """A batching server under concurrent /search and /rerank: each
        response equals the unbatched engine's."""
        from concurrent.futures import ThreadPoolExecutor

        from qrag_tpu_torch.documents import Document

        docs = [{"id": str(i), "content": c} for i, c in enumerate(contents[:20])]
        q = unit(16)
        with self._serve(engine, batching=True) as port:
            with ThreadPoolExecutor(24) as pool:
                s_f = [pool.submit(_post, port, "/search", {"vectors": [q[i].tolist()], "k": 10})
                       for i in range(16)]
                r_f = [pool.submit(_post, port, "/rerank", {"query": keyword[i], "documents": docs,
                                                            "top_k": 5})
                       for i in range(8)]
                searches = [f.result() for f in s_f]
                reranks = [f.result() for f in r_f]
            stats = _get(port, "/stats")["batcher"]
        direct = engine.search(q, k=10)
        for i, resp in enumerate(searches):
            if [h["index"] for h in resp["results"][0]] != list(direct.indices[i]):
                raise AssertionError(f"batched /search {i} differs from the unbatched engine")
        objs = [Document(d["id"], d["content"]) for d in docs]
        for i, resp in enumerate(reranks):
            want = engine.rerank(keyword[i], objs, 5)
            if [e["document"]["id"] for e in resp["documents"]] != [d.id for d, _ in want["documents"]]:
                raise AssertionError(f"batched /rerank {i} differs from the unbatched engine")
            np.testing.assert_allclose([e["score"] for e in resp["documents"]],
                                       [s for _, s in want["documents"]], rtol=1e-6)
        print(f"--batching server: 16 concurrent /search B=1 and 8 /rerank (20 documents) "
              f"equal the unbatched engine; batcher stats {stats}")

    def routed_latency(self, engine):
        lat = []
        with self._serve(engine) as port:
            for i in range(21):
                body = {"query": f"find the advertisement in episode {i}", "k": 10,
                        "candidates": 100, "reranker_type": "auto"}
                t0 = time.perf_counter()
                _post(port, "/search_rerank", body)
                lat.append(time.perf_counter() - t0)
        lat = sorted(lat[1:])
        print(f"timing [{self.card}]: HTTP /search_rerank auto (text, routed) B=1 k=10 "
              f"candidates=100: p50 {1e3 * lat[len(lat) // 2]:.3f} ms, "
              f"p90 {1e3 * lat[int(0.9 * len(lat))]:.3f} ms, min {1e3 * lat[0]:.3f} ms "
              f"(20 requests)", flush=True)

    def bounded_int8_path(self, x):
        """(a) topk_mode="bounded", bounded_scan="int8", f32 store."""
        from qrag_tpu_torch.ops.cuda import fused_scan

        engine, snap = self._engine(x, "int8 bounded path", {"bounded_scan": "int8"})
        unit = self._unit(2)
        q1, q64, r1 = unit(1), unit(64), unit(1)
        with self._serve(engine) as port:
            fused_scan.reset_launches()
            s1 = _post(port, "/search", {"vectors": q1.tolist(), "k": 10})
            s64 = _post(port, "/search", {"vectors": q64.tolist(), "k": 10})
            st = _post(port, "/search", {"query": "find the advertisement", "k": 10})
            rr1 = _post(port, "/search_rerank", {"vectors": r1.tolist(), "k": 10, "candidates": 100})
            stats = _get(port, "/stats")
            launches = self._launched([("int8", 2)], "int8 bounded path")
        qtext = engine.embedder(["find the advertisement"])
        ties = self._check_search(snap, ((q1, s1), (q64, s64), (qtext, st)))
        print(f"int8 bounded /search B=1, B=64, text: indices equal the f32 "
              f"oracle (sub-noise tie reorders: {ties})")
        self._check_rerank(snap, ((r1, rr1),))
        idx_stats = stats["index"]
        print("int8 bounded /search_rerank B=1 (k=10, candidates=100): equal to "
              "the plain composition; /stats: bounded_escalations="
              f"{idx_stats['bounded_escalations']} fallback_rows="
              f"{idx_stats['verified_fallback_rows']} effective_topk_modes="
              f"{idx_stats['effective_topk_modes']}", flush=True)
        self.int8_kernel_timings(engine, unit)
        self.census(engine.index, unit, "int8")
        self.search_timings(engine.index, unit, "int8 bounded")
        return launches

    def quantized_path(self, x):
        """(b) quantization="int8", quant_scan="window", bf16 store: the
        kernel's top-1 int arm; then the lean, own-domain and row modes."""
        torch = self.torch
        from qrag_tpu_torch.index.quantized_index import QuantizedFlatIndex
        from qrag_tpu_torch.ops import int8_domain as i8
        from qrag_tpu_torch.ops.cuda import fused_scan

        engine, snap = self._engine(
            x, "quantized window path",
            {"quantization": "int8", "quant_scan": "window", "dtype": "bfloat16"},
        )
        index = engine.index
        unit = self._unit(3)
        q64 = unit(64)
        body = {"vectors": q64.tolist(), "k": 10}
        with self._serve(engine) as port:
            fused_scan.reset_launches()
            s64 = _post(port, "/search", body)
            index.exact_scores = False  # the lean (gather-free) mode
            s64_lean = _post(port, "/search", body)
            index.exact_scores = True
            st = _post(port, "/search", {"query": "find the advertisement", "k": 10})
            stats = _get(port, "/stats")
            launches = self._launched([("int8", 1)], "quantized window path")
        print(f"quantized window /stats layout: {stats['index']['layout']}; "
              f"text query hits {[h['index'] for h in st['results'][0]]}")
        truth = self._f32_truth(x, q64, 10)
        qt = torch.from_numpy(q64).to(self.dev)
        for lean, got in ((False, s64), (True, s64_lean)):
            got_idx = np.asarray([[h["index"] for h in r] for r in got["results"]])
            index.exact_scores = not lean
            with _twin_planes():
                _, want = index.search_device(qt, 10)
            if not np.array_equal(got_idx, want.cpu().numpy()):
                raise AssertionError(f"lean={lean}: kernel vs twin planes differ")
            print(f"quantized window{' lean' if lean else ''} /search B=64 k=10: "
                  f"index-for-index equal to the twin's planes; recall@10 vs the "
                  f"f32 oracle {_recall(got_idx, truth):.4f}", flush=True)
        index.exact_scores = True
        self.search_timings(index, unit, "quantized window")
        self.search_profile(index, unit, "quantized window")
        del engine, index, snap
        self._free()

        idx = QuantizedFlatIndex.from_numpy(
            x, metric="l2", device=self.dev, scan="window", domain_exact=True
        )
        snap = idx.device_buffers()
        fused_scan.reset_launches()
        res = idx.search(q64, k=10)
        self._launched([("int8", 2)], "own-domain index")
        x8, scales, _ = snap.extras["int8w"]
        ov, oi = i8.full_topk_int8_domain(
            qt, x8, scales, snap.extras["int8w_isq"], 10, valid_rows=snap.valid
        )
        _check_own(res.indices, -res.scores, oi.cpu().numpy(), ov.cpu().numpy())
        print(f"own-domain QuantizedFlatIndex(domain_exact=True) B=64 k=10: equal "
              f"to full_topk_int8_domain (escalations={idx.bounded_escalations}, "
              f"full sorts={idx.fallback_rows}); recall@10 vs the f32 oracle "
              f"{_recall(res.indices, truth):.4f}", flush=True)
        del idx, snap, x8, scales
        self._free()

        idx = QuantizedFlatIndex.from_numpy(x, metric="l2", device=self.dev, scan="row")
        res = idx.search(q64, k=10)
        print(f"quantized row scan B=64 k=10: recall@10 vs the f32 oracle "
              f"{_recall(res.indices, truth):.4f}", flush=True)
        del idx
        return launches

    def _f32_truth(self, x, q, k):
        """Top-k indices of the f32 rows (before any bf16 store)."""
        torch = self.torch
        from qrag_tpu_torch.ops import bounded_topk as bt

        xt = torch.from_numpy(x).to(self.dev)
        sq = (xt * xt).sum(1)
        _, idx = bt._exact_full_sort(torch.from_numpy(q).to(self.dev), xt, sq, k, "l2", None)
        del xt, sq
        self._free()
        return idx.cpu().numpy()

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

    def _graph_ms(self, fn, reps, replays=3):
        """Device time of one ``fn()`` with the host out of the picture:
        ``reps`` calls captured in a CUDA graph on a side stream (the
        wrappers launch on PyTorch's current stream), replays timed
        with events."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(replays):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / (reps * replays)
        del graph
        return ms

    def _host_us(self, fn, calls):
        """Host cost of one ``fn()``: the host clock over ``calls``
        un-synchronised calls after a synchronise."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        return us

    def _kernel_row(self, key, b, n, d, pairs, err, gemm_ms, kernel):
        """One ``kernels`` entry: times measured here, the bound from
        this run's shapes (each input read once, each output written
        once; operations over the card's peak for their type), the arm
        by the launch count that rose."""
        domain, planes = key
        arm = self._arm_of(kernel)
        item = 1 if domain == "int8" else 2
        nbytes = (b + n) * d * item + planes * b * (n // WINDOW) * 4
        if domain == "bf16":
            nbytes += (n + b) * 4  # row_add, col_add
        t_bytes = nbytes / HBM_BYTES_S
        t_ops = 2 * b * n * d / (INT8_OPS_S if domain == "int8" else BF16_FLOPS_S)
        self.kernel_rows[key + (b,)] = row = {
            "ms": float(np.median([k for _, k in pairs])),
            "plain_ms": float(np.median([p for p, _ in pairs])),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err,
            "gemm_floor_ms": gemm_ms,
            "device_ms": self._graph_ms(kernel, 5),
            "host_us": self._host_us(kernel, 50 if b > 1 else 200),
            "arm": arm,
        }
        print(f"kernel row {key} B={b} N={n} d={d} [{self.card}]: {row}", flush=True)

    def _time_pairs(self, twin, kernel):
        """plain, kernel, kernel, plain (twice)."""
        pairs = []
        for _ in range(2):
            p0 = self._events_ms(twin, 3)
            k_ms = self._events_ms(kernel, 20)
            pairs.append((p0, k_ms))
        return pairs

    def timings(self, engine, port, unit):
        torch = self.torch
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.window_scan import make_lane_rank

        snap, (scan, _, _) = engine.index._bounded_buffers()
        lr = make_lane_rank(scan.shape[0], self.dev)
        ra = (-snap.sqnorms + torch.where(snap.valid, 0.0, -torch.inf))[None, :]
        n, d = scan.shape
        for b in (1024, 64, 1):
            q = torch.from_numpy(unit(b)).to(self.dev)
            ca = -(q * q).sum(1, keepdim=True)
            qb = q.bfloat16()
            gemm_ms = self._events_ms(lambda: torch.matmul(qb, scan.T), 10)
            for planes in (1, 2, 3):
                twin = _float_twin(planes)
                err = self._compare(qb, scan, 2.0, ra, ca, planes, dyadic=False)[0]
                def kernel(planes=planes):
                    return fused_scan.packed_window_scan(qb, scan, lr, ra, ca, 2.0, planes)

                pairs = self._time_pairs(lambda: twin(qb, scan, lr, ra, ca, 2.0), kernel)
                print(f"timing [{self.card}]: scan kernel bf16 B={b} N={n} d={d} "
                      f"planes={planes}: kernel {np.median([k for _, k in pairs]):.4f} ms, "
                      f"plain twin {np.median([p for p, _ in pairs]):.4f} ms (runs {pairs}); "
                      f"torch.matmul bf16 GEMM alone {gemm_ms:.4f} ms; max |hi err| {err:.3g}")
                self._kernel_row(("bf16", planes), b, n, d, pairs, err, gemm_ms, kernel)

        self.cut_timings("bf16", lambda b: torch.from_numpy(unit(b)).to(self.dev).bfloat16(),
                         scan, ra)
        self.census(engine.index, unit, "bf16")
        self.search_timings(engine.index, unit, "default bf16")
        self.search_profile(engine.index, unit, "default bf16")
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

    def cut_timings(self, domain, queries, corpus, ra=None):
        """Where the arms cut: device time (graph replays) of each arm,
        forced, at planes=2 and B=1..256 on the engine's buffers."""
        torch = self.torch
        from qrag_tpu_torch.ops.cuda import fused_scan

        rows = []
        for b in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            q = queries(b)
            ca = None if ra is None else -(q.float() ** 2).sum(1, keepdim=True)
            alpha = 1.0 if ra is None else 2.0
            ms = {arm: self._graph_ms(
                lambda arm=arm: fused_scan.packed_window_scan_cuda(
                    q, corpus, ra, ca, alpha, 2, arm), 5)
                for arm in ("general", "wide")}
            rows.append((b, round(ms["general"], 4), round(ms["wide"], 4),
                         fused_scan.plan(q, corpus).arm))
        print(f"timing [{self.card}]: scan kernel {domain} planes=2 N={corpus.shape[0]} "
              f"d={corpus.shape[1]}, device_ms per arm (B, general, wide, planned arm): "
              f"{rows}; cut WIDE_MIN_B={fused_scan.WIDE_MIN_B[domain == 'int8']}", flush=True)

    def search_timings(self, index, unit, label):
        """index.search B=1024 k=10 over ten different random batches
        (host clock; each call ends in a device->host copy).  Its scans
        must go through the wide arm, a B=1 search through the general
        one."""
        from qrag_tpu_torch.ops.cuda import fused_scan

        before = dict(fused_scan.arm_launches)
        index.search(unit(1), k=10)
        one = {a: c - before[a] for a, c in fused_scan.arm_launches.items()}
        if one["wide"] or not one["general"]:
            raise AssertionError(f"{label}: a B=1 search launched {one}")
        before = dict(fused_scan.arm_launches)
        runs = []
        for _ in range(10):
            q = unit(1024)
            esc0, fb0 = index.bounded_escalations, index.fallback_rows
            t0 = time.perf_counter()
            index.search(q, k=10)
            runs.append((
                1e3 * (time.perf_counter() - t0),
                index.bounded_escalations - esc0,
                index.fallback_rows - fb0,
            ))
        many = {a: c - before[a] for a, c in fused_scan.arm_launches.items()}
        if many["general"] or not many["wide"]:
            raise AssertionError(f"{label}: the B=1024 searches launched {many}")
        print(f"{label} index.search scan launches per arm: B=1 {one}, 10 x B=1024 {many}")
        ms = [r[0] for r in runs]
        tier1 = [r[0] for r in runs if not r[1] and not r[2]]
        print(f"timing [{self.card}]: {label} index.search B=1024 k=10 over "
              f"{index.ntotal:,} x 768, 10 random batches: median "
              f"{np.median(ms):.3f} ms ({1024e3 / np.median(ms):.1f} QPS), mean "
              f"{np.mean(ms):.3f} ms ({1024e3 / np.mean(ms):.1f} QPS); "
              f"escalated {sum(r[1] for r in runs)}/10, full sort "
              f"{sum(r[2] for r in runs)}/10; batches with neither: median "
              f"{np.median(tier1) if tier1 else float('nan'):.3f} ms; "
              f"per batch (ms, escalated, full sort) "
              f"{[(round(a, 3), b, c) for a, b, c in runs]}", flush=True)

    def search_profile(self, index, unit, label, calls=5):
        """Where index.search B=1024 k=10 spends its time: a
        ``torch.profiler`` trace of ``calls`` calls (reported, never
        asserted; profiled wall times run above unprofiled ones)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        # batches that tier 1 certifies (the common case; an escalated
        # batch's ~190 ms full sort would drown the rest), found by a
        # run before the trace
        batches = []
        for _ in range(4 * calls):
            q = unit(1024)
            esc0, fb0 = index.bounded_escalations, index.fallback_rows
            index.search(q, k=10)
            if (index.bounded_escalations, index.fallback_rows) == (esc0, fb0):
                batches.append(q)
            if len(batches) == calls:
                break
        if len(batches) < calls:
            print(f"profile {label}: not measured ({len(batches)} of {4 * calls} batches "
                  f"certified in tier 1)")
            return
        torch.cuda.synchronize()
        esc0, fb0 = index.bounded_escalations, index.fallback_rows
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for q in batches:
                index.search(q, k=10)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / calls
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
        if not by_name:
            print(f"profile {label}: not measured (the profiler saw no device time)")
            return
        busy = sum(by_name.values()) / calls
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"profile [{self.card}]: {label} index.search B=1024 k=10, {calls} calls "
              f"(escalated {index.bounded_escalations - esc0}, full sort "
              f"{index.fallback_rows - fb0}): wall {wall:.3f} ms/call, device busy "
              f"{busy:.3f} ms/call, idle share {1 - busy / wall:.2f}; device ms/call by "
              f"kernel: {[(name[:60], round(ms / calls, 3)) for name, ms in top]}", flush=True)

    def census(self, index, unit, label):
        """Certificate census of a bounded index over 5 random batches
        per (B, k): how often the 4x tier and the full sort ran
        (reported, never asserted; the f32-contract int8 mode escalates
        or falls back much more than bf16)."""
        torch = self.torch

        for b, k in ((1, 10), (1, 100), (1024, 10), (1024, 100)):
            events = [
                index._bounded_search(torch.from_numpy(unit(b)).to(self.dev), k)
                for _ in range(5)
            ]
            print(f"certificates {label} [{self.card}]: B={b} k={k}: escalated "
                  f"{sum(e[4] for e in events)}/5, full sort "
                  f"{sum(e[2] for e in events)}/5, patched windows "
                  f"{[int(e[3]) for e in events]}", flush=True)

    def int8_kernel_timings(self, engine, unit):
        """Int8 arm vs its twin on the engine's own codes and real query
        codes, at B=1 and B=1024, beside the torch._int_mm GEMM alone."""
        torch = self.torch
        from qrag_tpu_torch.ops import bounded_topk as bt
        from qrag_tpu_torch.ops import window_scan as ws
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.quantize import quantize_rows

        _, (q8x, _, _, _, _, lr) = engine.index._bounded_buffers_int8()
        n, d = q8x.shape
        for b in (1024, 64, 1):
            q8, _ = quantize_rows(torch.from_numpy(unit(b)).to(self.dev))
            qpad = torch.nn.functional.pad(q8, (0, 0, 0, max(24, b) - b))
            gemm_ms = self._events_ms(lambda: torch._int_mm(qpad, q8x.T), 10)
            for planes in (1, 2):
                twin = (
                    (lambda: (ws.packed_window_scan(q8, q8x, lr),))
                    if planes == 1
                    else (lambda: bt.packed_window_scan_top2_int(q8, q8x, lr))
                )
                got = fused_scan.packed_window_scan(q8, q8x, lr, planes=planes)
                ref = twin()
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    raise AssertionError(f"int8 planes={planes} B={b}: kernel != twin")
                def kernel(planes=planes):
                    return fused_scan.packed_window_scan(q8, q8x, lr, planes=planes)

                pairs = self._time_pairs(twin, kernel)
                print(f"timing [{self.card}]: scan kernel int8 B={b} N={n} d={d} "
                      f"planes={planes}: kernel {np.median([k for _, k in pairs]):.4f} ms, "
                      f"plain twin {np.median([p for p, _ in pairs]):.4f} ms (runs {pairs}); "
                      f"torch._int_mm GEMM alone {gemm_ms:.4f} ms; planes bit-equal", flush=True)
                self._kernel_row(("int8", planes), b, n, d, pairs, 0.0, gemm_ms, kernel)
        self.cut_timings(
            "int8", lambda b: quantize_rows(torch.from_numpy(unit(b)).to(self.dev))[0], q8x)

    def gather_timings(self, snap):
        """The gather kernel on the engine's f32 store (1,250,176 x 768)
        beside its twin, torch.index_select and the bytes bound."""
        torch = self.torch
        from qrag_tpu_torch.ops import gather_rows as tg

        x = snap.matrix
        gen = torch.Generator(device=self.dev).manual_seed(5)
        for m in (100, 6400, 102400):
            idx = torch.randint(0, snap.ntotal, (m,), generator=gen, device=self.dev)
            if not torch.equal(tg.gather_rows(x, idx), tg.plain_gather_rows(x, idx)):
                raise AssertionError(f"gather M={m}: kernel != twin")
            pairs = self._time_pairs(lambda: tg.plain_gather_rows(x, idx),
                                     lambda: tg.gather_rows(x, idx))
            def kernel():
                return tg.gather_rows(x, idx)

            def library():
                return torch.index_select(x, 0, idx)

            lib_ms = self._events_ms(library, 20)
            t_bytes = 2 * m * x.shape[1] * x.element_size() / HBM_BYTES_S
            row = {
                "ms": float(np.median([k for _, k in pairs])),
                "plain_ms": float(np.median([p for p, _ in pairs])),
                "bound_ms": 1e3 * t_bytes,
                "bound_by": "bytes",
                "max_abs_err": 0.0,
                "library_ms": lib_ms,
                "device_ms": self._graph_ms(kernel, 20),
                "host_us": self._host_us(kernel, 300),
                "library_device_ms": self._graph_ms(library, 20),
                "library_host_us": self._host_us(library, 300),
            }
            self.kernel_rows[("gather_rows", m)] = row
            print(f"timing [{self.card}]: gather_rows f32 M={m} d={x.shape[1]} from "
                  f"N={x.shape[0]}: {row} (runs {pairs})", flush=True)

    def _kernel_split(self, fn):
        """Device time of one ``fn()`` by kernel name (torch.profiler):
        the scan_topk partial kernel and the merge kernel apart."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if "scan_topk_" in ev.key:
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = ev.cuda_time_total
                name = ev.key.split("scan_topk_")[1].split("_kernel")[0]
                out[name] = out.get(name, 0.0) + us / 1e3
        if len(out) < 2 or "merge" not in out or min(out.values()) <= 0.0:
            raise AssertionError(
                f"scan_topk: the profiler did not time the partial and the merge kernel: {out}"
            )
        return out

    def scan_topk_timings(self, snap, unit):
        """The scan_topk kernel (both compute types) on the engine's f32
        store and real queries, beside its twin, a matmul + torch.topk
        composite and the bound; then the stream arm against the arm
        that takes over past its cut."""
        torch = self.torch
        from qrag_tpu_torch.ops import scan_topk as ts
        from qrag_tpu_torch.ops.cuda import scan_topk as ct

        x, sq, valid = snap.matrix, snap.sqnorms, snap.valid
        n, d = x.shape
        ct.reset_launches()
        for b, k in ((1024, 10), (1, 100)):
            q = torch.from_numpy(unit(b)).to(self.dev)
            qsq = (q * q).sum(1)

            def composite():
                g = 2.0 * (q @ x.T) - qsq[:, None] - sq[None, :]
                return torch.topk(torch.where(valid[None, :], g, -torch.inf), k)

            comp_ms = self._events_ms(composite, 5)
            comp_device_ms = self._graph_ms(composite, 2, 2)
            # the product alone, as the library computes it, per compute type
            qb, xb = q.bfloat16(), x.bfloat16()

            def composite_bf16():
                # the bf16 product comes out in bf16 (f32 accumulation
                # inside, rounded on output); the l2 terms promote to f32
                g = 2.0 * (qb @ xb.T) - qsq[:, None] - sq[None, :]
                return torch.topk(torch.where(valid[None, :], g, -torch.inf), k)

            comp_bf16_ms = self._events_ms(composite_bf16, 5)
            gemm_ms = {torch.float32: self._events_ms(lambda: q @ x.T, 5),
                       torch.bfloat16: self._events_ms(lambda: qb @ xb.T, 5)}
            del xb
            for cd in (torch.float32, torch.bfloat16):
                bf16 = cd == torch.bfloat16

                calls = [0]
                arms_before, types_before = dict(ct.arm_launches), dict(ct.launches)

                def kernel():
                    calls[0] += 1
                    return ts.scan_topk(q, x, k, "l2", sq, valid, cd)

                got = kernel()
                want = ts.plain_scan_topk(q, x, k, "l2", sq, valid, cd)
                n_diff = self._check_topk(got, want, q, x, "l2", bf16)[0]
                fin = torch.isfinite(want[0])
                err = float((got[0][fin] - want[0][fin]).abs().max())
                pairs = []
                for _ in range(2):
                    p0 = self._events_ms(lambda: ts.plain_scan_topk(q, x, k, "l2", sq, valid, cd), 1)
                    k_ms = self._events_ms(kernel, 5 if b > 1 else 20)
                    pairs.append((p0, k_ms))
                t_bytes = ((b + n) * d * 4 + (b + n) * 4 + n + b * k * 8) / HBM_BYTES_S
                t_ops = 2 * b * n * d / (BF16_FLOPS_S if bf16 else FP32_FLOPS_S)
                row = {
                    "ms": float(np.median([kk for _, kk in pairs])),
                    "plain_ms": float(np.median([p for p, _ in pairs])),
                    "bound_ms": 1e3 * max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "max_abs_err": err,
                    "library_ms": None,
                    "library_composite_ms": comp_ms,
                    "library_composite_device_ms": comp_device_ms,
                    # the bf16 rows' own composite (None for the f32 rows)
                    "library_composite_bf16_ms": comp_bf16_ms if bf16 else None,
                    "gemm_floor_ms": gemm_ms[cd],
                    "device_ms": self._graph_ms(kernel, 3 if b > 1 else 10),
                    # few calls: the launch queue must not fill, or the
                    # host clock waits for the device
                    "host_us": self._host_us(kernel, 10 if b > 1 else 30),
                    "kernels_ms": self._kernel_split(kernel),
                }
                # the arm that ran, from the wrapper's own counts: one
                # arm, once for every call made above (a graph's replays
                # are no calls of the wrapper), all of this compute type
                ran = {a: c - arms_before[a] for a, c in ct.arm_launches.items()
                       if c != arms_before[a]}
                name = str(cd).split(".")[-1]
                rose = {t: c - types_before[t] for t, c in ct.launches.items()}
                other = "float32" if bf16 else "bfloat16"
                if len(ran) != 1 or rose != {name: calls[0], other: 0} or (
                    list(ran.values()) != [calls[0]]
                ):
                    raise AssertionError(
                        f"scan_topk B={b} {cd}: {calls[0]} calls, launches by arm {ran}, "
                        f"by compute type {rose}"
                    )
                (row["arm"],) = ran
                row["timing_launches"] = calls[0]
                cfg = ct.plan(q, x, k, bf16)  # the wrapper's own choice for these operands
                if cfg.arm != row["arm"]:
                    raise AssertionError(f"scan_topk: plan() names {cfg.arm}, {row['arm']} ran")
                self.kernel_rows[("scan_topk", name, b)] = row
                # what the arm reads of the store: once per query tile
                print(f"timing [{self.card}]: scan_topk {cd} l2 B={b} k={k} N={n} d={d}: {row} "
                      f"(runs {pairs}; matmul + torch.topk composite {comp_ms:.4f} ms; "
                      f"index slots differing at near-ties {n_diff}; config {cfg}, "
                      f"store passes {-(-b // cfg.qt)})", flush=True)
        # the cut of the stream arm: it reads the store once per 8 queries
        # and the two wgmma arms against each other on both sides of theirs
        for b, others in ((8, ("wgmma64",)), (16, ("wgmma64", "wgmma128")), (16, ("general",)),
                          (32, ("general", "tiled")), (32, ("wgmma64", "wgmma128")),
                          (64, ("general", "tiled")), (64, ("wgmma64", "wgmma128")),
                          (128, ("wgmma128",)), (1024, ("wgmma128",))):
            q = torch.from_numpy(unit(b)).to(self.dev)
            cd = torch.bfloat16 if others[0].startswith("wgmma") else torch.float32
            first = ("stream",) if b <= 64 and "wgmma128" not in others else ()
            if b > 64:
                first = ("wgmma64",)
            t = {arm: self._graph_ms(
                     lambda: self._scan_topk_arm(q, x, 10, "l2", sq, valid, cd, arm), 3)
                 for arm in first + others}
            print(f"timing [{self.card}]: scan_topk {cd} l2 B={b} k=10 by arm "
                  f"(graph replay): {t}", flush=True)
        self._free()

    # -------------------------------------------------------------- phase 7

    def models_path(self, n_episodes=2048, chunks_per_episode=32):
        """The trained models and the MCP ingestion path with the shipped
        weights: the models at bf16 against themselves at f32, ingestion
        of a corpus_gen corpus over MCP, the HTTP server over the
        ingested index, then the models' timings.  Returns the kernel
        launches of the path's runs."""
        import shutil
        import tempfile

        from qrag_tpu_torch.pipeline import corpus_gen

        models = self.models_vs_f32()
        chunks = corpus_gen.generate_corpus(n_episodes, chunks_per_episode, seed=0)
        tmp = tempfile.mkdtemp(prefix="qrag_smoke_")
        try:
            index_path, meta_to_chunk, launches = self.mcp_ingest(tmp, chunks, models)
            launches.update(self.models_serving(index_path, chunks, meta_to_chunk, models))
            self.model_timings(chunks, models)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self._free()
        return launches

    def models_vs_f32(self):
        """Both shipped models in bf16 on the card against themselves at
        f32 from the same carried weights: sigmoid scores within
        ``BF16_SCORE_ATOL``, the top-10 order equal but between
        documents whose f32 scores lie within it, embeddings' cosine to
        their f32 twins at or above ``BF16_COSINE_FLOOR``."""
        torch = self.torch
        from qrag_tpu_torch.config import ClassicalConfig
        from qrag_tpu_torch.models import bi_encoder as be
        from qrag_tpu_torch.models import cross_encoder as ce
        from qrag_tpu_torch.pipeline import corpus_gen

        cc = ClassicalConfig(method="cross-encoder", model_cache_dir="artifacts",
                             model_name="cross_encoder")
        scorer = ce.CrossEncoderScorer.from_config(cc, device=self.dev)
        scorer32 = ce.CrossEncoderScorer.from_config(cc, device=self.dev, dtype=torch.float32)
        cfg = scorer.cfg
        geometry = (cfg.head_type, cfg.dim, cfg.n_heads, cfg.n_layers, cfg.n_experts,
                    cfg.max_len, tuple(scorer.model.pos_emb.shape))
        if scorer.dtype != torch.bfloat16 or geometry != (
                "interaction", 128, 4, 2, 4, 224, (128, 128)):
            raise AssertionError(f"cross-encoder: {scorer.dtype} {geometry}")
        tol = ce.BF16_SCORE_ATOL
        chunks = corpus_gen.generate_corpus(64, 32, seed=0)
        rng = np.random.RandomState(0)
        worst, reorders = 0.0, 0
        for _ in range(4):
            src = int(rng.randint(len(chunks)))
            query = corpus_gen.make_query(chunks[src], rng)
            docs = [chunks[int(i)].text for i in rng.randint(len(chunks), size=99)]
            docs.append(chunks[src].text)
            sb, sf = scorer.score(query, docs), scorer32.score(query, docs)
            worst = max(worst, float(np.abs(sb - sf).max()))
            ob = np.argsort(-sb, kind="stable")[:10]
            of = np.argsort(-sf, kind="stable")[:10]
            if not (np.abs(sf[ob] - sf[of]) <= tol).all():
                raise AssertionError(f"bf16 top-10 {ob} vs f32 {of} beyond the tolerance")
            reorders += int((ob != of).sum())
        if worst > tol:
            raise AssertionError(f"cross-encoder bf16 vs f32: max |score diff| {worst} > {tol}")
        emb = be.TrainedEmbedder(weights_dir="artifacts/bi_encoder", device=self.dev)
        emb32 = be.TrainedEmbedder(weights_dir="artifacts/bi_encoder", device=self.dev,
                                   dtype=torch.float32)
        texts = [c.text for c in chunks[:1000]]
        texts += [corpus_gen.make_query(c, rng) for c in chunks[:100]] + [""]
        cos = float((emb(texts) * emb32(texts)).sum(1).min())
        if emb.dtype != torch.bfloat16 or emb.dim != 128 or cos < be.BF16_COSINE_FLOOR:
            raise AssertionError(f"bi-encoder {emb.dtype} dim {emb.dim}: min cosine {cos}")
        print(f"models bf16 vs f32 on {self.dev} (shipped weights; cross-encoder "
              f"{geometry}): 400 pairs, max |sigmoid diff| {worst:.5f} (tolerance {tol}), "
              f"top-10 reorders within it {reorders}; bi-encoder min cosine over "
              f"{len(texts)} texts {cos:.6f} (floor {be.BF16_COSINE_FLOOR})", flush=True)
        return {"scorer": scorer, "scorer32": scorer32, "embedder": emb, "embedder32": emb32}

    def _write_transcripts(self, root, chunks, show):
        """One transcript file per corpus chunk, laid out as the
        reference's S3 keys: <show>/<episode>/<episode>_c<i>_transcript.json."""
        import os

        from concurrent.futures import ThreadPoolExecutor

        meta_to_chunk, files = {}, []
        for i, c in enumerate(chunks):
            episode, ci = c.metadata.split("/")[1].split("#c")
            name = f"{episode}_c{int(ci):02d}_transcript"
            files.append((os.path.join(root, show, episode, name + ".json"), c.text))
            meta_to_chunk[f"{show}/{name}"] = i
        for d in sorted({os.path.dirname(path) for path, _ in files}):
            os.makedirs(d, exist_ok=True)

        def write(item):
            with open(item[0], "w") as f:
                json.dump({"text": item[1]}, f)

        with ThreadPoolExecutor(16) as pool:
            list(pool.map(write, files))  # set-up: the file system's latency, overlapped
        return meta_to_chunk

    def mcp_ingest(self, tmp, chunks, models):
        """ProcessTranscriptsToEmbeddings, then SearchIndex (plain and
        reranked), through the port's McpClient against its MCP server
        on the card with the trained embedder."""
        import os

        from qrag_tpu_torch.config import EmbeddingConfig
        from qrag_tpu_torch.index import faiss_io
        from qrag_tpu_torch.pipeline.storage import LocalTranscriptStore
        from qrag_tpu_torch.serving.mcp_client import McpClient
        from qrag_tpu_torch.serving.mcp_server import create_tool_service, serve_in_thread

        show = "Piers_Morgan_Uncensored"
        t0 = time.perf_counter()
        root = os.path.join(tmp, "transcripts")
        meta_to_chunk = self._write_transcripts(root, chunks, show)
        write_s = time.perf_counter() - t0
        service = create_tool_service(
            store=LocalTranscriptStore(root),
            config=EmbeddingConfig(provider="trained", model="artifacts/bi_encoder", dim=128),
            device=self.dev,
        )
        server = serve_in_thread(service)
        index_path = os.path.join(tmp, "ingested.faiss")
        progress = []  # (arrival time, progress, message)
        try:
            client = McpClient(
                f"http://127.0.0.1:{server.server_address[1]}/mcp",
                on_progress=lambda p, t, m: progress.append((time.perf_counter(), p, m)),
            )
            client.initialize()
            if len(client.list_tools()) != 5:
                raise AssertionError("tools/list")
            t0 = time.perf_counter()
            ok, out = client.call_tool("ProcessTranscriptsToEmbeddings",
                                       {"show_name": show, "index_path": index_path})
            ingest_s = time.perf_counter() - t0
            t_end = time.perf_counter()
            n = len(chunks)
            # the tool's stages, from when its progress events arrived
            marks = [t for t, _, m in progress if m and not m.startswith("embedding texts")]
            stages = dict(zip(("read", "embed", "store"),
                              np.diff(marks[:3] + [t_end]).round(2).tolist()))
            if not ok or (out["embeddings_created"], out["total_vectors"]) != (n, n):
                raise AssertionError(f"ingestion: {out}")
            data = faiss_io.read_flat_index(index_path)
            meta = faiss_io.read_metadata(index_path)
            texts = [chunks[meta_to_chunk[m]].text for m in meta]
            t0 = time.perf_counter()
            reread = len(LocalTranscriptStore(root).read_show(show))
            reread_s = time.perf_counter() - t0
            # the tool's arithmetic: the mean of a text's one chunk vector,
            # normalized, through a list of floats
            t0 = time.perf_counter()
            raw = models["embedder"](texts)
            embed_s = time.perf_counter() - t0
            want = np.stack([v / np.linalg.norm(v) for v in raw]).astype(np.float32)
            vec_err = float(np.abs(np.asarray(data.vectors) - want).max())
            if data.ntotal != n or vec_err > 1e-6:
                raise AssertionError(f"stored vectors vs the bi-encoder: ntotal {data.ntotal}, "
                                     f"max |diff| {vec_err}")
            print(f"MCP ingestion [{self.card}]: {n:,} transcripts ({len(set(c.episode for c in chunks))} "
                  f"episodes) written in {write_s:.1f} s; ProcessTranscriptsToEmbeddings "
                  f"{ingest_s:.1f} s ({n / ingest_s:.0f} transcripts/s, {len(progress)} progress "
                  f"events; stages by their progress events, s: {stages}); stored vectors "
                  f"equal the bi-encoder's outputs (max |diff| {vec_err:.2e}); afterwards, "
                  f"alone: the store re-read {reread:,} transcripts in {reread_s:.1f} s, the "
                  f"bi-encoder embedded them in {embed_s:.1f} s", flush=True)
            engine_searches = self._mcp_search(client, service, index_path, chunks,
                                               meta_to_chunk, models)
        finally:
            server.shutdown()
            server.server_close()
        return index_path, meta_to_chunk, engine_searches

    def _mcp_search(self, client, service, index_path, chunks, meta_to_chunk, models):
        """SearchIndex against the f32 exact top-10 (and, reranked, the
        plain fidelity composition) over the stored vectors; recall@10 of
        paraphrases as a record.  Returns the scan kernel's launches."""
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.pipeline import corpus_gen

        rng = np.random.RandomState(1)
        sources = [int(i) for i in rng.randint(len(chunks), size=128)]
        queries = [corpus_gen.make_query(chunks[i], rng) for i in sources]
        fused_scan.reset_launches()
        t0 = time.perf_counter()
        plain = [client.call_tool("SearchIndex", {"index_path": index_path, "query": q, "k": 10})
                 for q in queries]
        search_s = time.perf_counter() - t0
        reranked = [client.call_tool("SearchIndex", {"index_path": index_path, "query": q,
                                                     "k": 10, "rerank": True})
                    for q in queries[:8]]
        launches = self._launched([("bf16", 2), ("bf16", 3)], "MCP SearchIndex")
        if not all(ok for ok, _ in plain + reranked):
            raise AssertionError("SearchIndex failed")
        (engine,) = service.get_tool("SearchIndex")._engines.values()
        snap = engine.index.device_buffers()
        qv = models["embedder"](queries[:8])
        ties = self._check_search(snap, [(qv[i:i + 1], {"results": [plain[i][1]["hits"]]})
                                         for i in range(8)])
        self._check_rerank(snap, [(qv[i:i + 1], {"results": [reranked[i][1]["hits"]],
                                                 "reranker_used": "quantum"})
                                  for i in range(8)])
        hits = [[meta_to_chunk[h["metadata"]] for h in out["hits"]] for _, out in plain]
        recall = float(np.mean([src in h for src, h in zip(sources, hits)]))
        print(f"MCP SearchIndex: k=10 equals the f32 exact top-10 over the stored vectors "
              f"(8 queries; sub-noise tie reorders {ties}); rerank=true equals the oracle "
              f"top-100 -> fidelity -> stable top-10; recall@10 of {len(queries)} make_query "
              f"paraphrases against their source chunk {recall:.4f} (a record); "
              f"{len(queries)} searches in {search_s:.2f} s", flush=True)
        return {("ingest", key): n for key, n in launches.items()}

    def models_serving(self, index_path, chunks, meta_to_chunk, models):
        """create_server over the ingested index, configured through the
        env channel for the trained embedder and the cross-encoder:
        /search with text, /rerank "classical" with 100 documents served
        by the cross-encoder on every batch, /search_rerank "auto"."""
        torch = self.torch
        from qrag_tpu_torch.config import QragConfig
        from qrag_tpu_torch.engine import QragEngine
        from qrag_tpu_torch.models import cross_encoder as ce
        from qrag_tpu_torch.ops.cuda import gather_rows as cg
        from qrag_tpu_torch.pipeline import corpus_gen

        env = {
            "QRAG_EMBEDDING_PROVIDER": "trained",
            "QRAG_EMBEDDING_MODEL": "artifacts/bi_encoder",
            "QRAG_CLASSICAL_METHOD": "cross-encoder",
            "QRAG_CLASSICAL_MODEL_CACHE_DIR": "artifacts",
            "QRAG_CLASSICAL_MODEL_NAME": "cross_encoder",
        }
        config = QragConfig().with_env_overrides(env)
        engine = QragEngine.from_faiss(index_path, config=config, device=self.dev)
        if type(engine.embedder).__name__ != "TrainedEmbedder":
            raise AssertionError(f"embedder {type(engine.embedder)}")
        snap = engine.index.device_buffers()
        classical = engine.controller.classical_reranker
        rng = np.random.RandomState(2)
        src = int(rng.randint(len(chunks)))
        query = corpus_gen.make_query(chunks[src], rng)
        contents = [chunks[int(i)].text for i in rng.randint(len(chunks), size=99)]
        contents.insert(17, chunks[src].text)
        docs = [{"id": str(i), "content": c} for i, c in enumerate(contents)]
        keyword = [f"find the advertisement about {chunks[i].rare[0]}" for i in range(4)]
        texts = [query] + keyword + [corpus_gen.make_query(chunks[i], rng) for i in range(3)]
        with self._serve(engine) as port:
            st = _post(port, "/search", {"query": query, "k": 10})
            rr = _post(port, "/rerank", {"query": query, "documents": docs, "top_k": 100,
                                         "reranker_type": "classical"})
            scorer = classical._cross_encoder
            forwards = scorer.forward_calls if scorer is not None else 0
            cg.reset_launches()
            auto = _post(port, "/search_rerank", {"queries": texts, "k": 10, "candidates": 100,
                                                  "reranker_type": "auto"})
            gather_launches = cg.launches
        ties = self._check_search(snap, [(engine.embedder([query]), st)])
        if forwards != -(-len(docs) // 32) or classical._active_method != "cross-encoder" or (
                rr["reranker_used"] != "classical"):
            raise AssertionError(f"/rerank classical: {forwards} cross-encoder forwards, "
                                 f"method {classical._active_method}, {rr['reranker_used']}")
        if scorer.dtype != torch.bfloat16:
            raise AssertionError(f"served scorer dtype {scorer.dtype}")
        # the plain composition: tokenize, the scorer at f32, stable sort
        tokens, mask = ce.tokenize_batch(query, contents, scorer.cfg.max_len)
        want = torch.sigmoid(models["scorer32"].logits(tokens, mask)).cpu().numpy()
        order = np.argsort(-want, kind="stable")
        got_ids = [int(e["document"]["id"]) for e in rr["documents"]]
        got_scores = np.asarray([e["score"] for e in rr["documents"]])
        tol = ce.BF16_SCORE_ATOL
        if sorted(got_ids) != list(range(len(docs))) or not (
                np.abs(want[got_ids] - want[order]) <= tol).all() or not (
                np.abs(got_scores - want[got_ids]) <= tol).all():
            raise AssertionError(f"/rerank classical order {got_ids[:10]} vs the plain "
                                 f"composition {order[:10].tolist()}")
        if gather_launches < 1:
            raise AssertionError("/search_rerank auto: the gather kernel was not launched")
        route = [engine.controller.select_reranker(t) == "quantum" for t in texts]
        self._check_routed(snap, engine.embedder(texts), route, auto, "auto")
        print(f"serving the ingested index (trained embedder, cross-encoder): /search text "
              f"equals the f32 oracle (tie reorders {ties}); /rerank classical 100 documents: "
              f"{forwards} cross-encoder forwards of 32-pair batches, no fallback, order of the "
              f"plain f32 composition within {tol} (source chunk at rank "
              f"{got_ids.index(17) + 1}); /search_rerank auto B={len(texts)} "
              f"({sum(route)} quantum) equals the plain routed composition, gather launches "
              f"{gather_launches}", flush=True)
        return {("ingest", "gather_rows"): gather_launches}

    def _model_profile(self, fn, calls, parts=None):
        """Device busy time, idle share and the device time of the
        model's parts (record_function ranges around attention, the MoE
        products and the layer norms; in a train step the backward's
        kernels go to the part whose forward op made them, by the
        autograd sequence number, and the optimizer's apart; the rest is
        elementwise work and copies), from a ``torch.profiler`` trace of
        ``calls`` calls.  ``parts={}``: busy time and idle share only
        (with remat, a backward would count its recomputed forward
        twice)."""
        from torch.profiler import record_function

        from qrag_tpu_torch.models import cross_encoder as ce

        if parts is None:
            parts = {"attention": (ce.Attention, ("project", "attend")),
                     "moe": (ce.MoEFFN, ("forward",)),
                     "layer_norm": (ce.LayerNorm, ("forward",))}
        saved = []
        try:
            return self._profile_parts(fn, calls, parts, saved, record_function)
        except Exception as e:  # noqa: BLE001 - a measurement, never a condition
            return {"profile": f"not measured ({e!r})"}
        finally:
            for cls, name, orig in saved:
                setattr(cls, name, orig)

    def _profile_parts(self, fn, calls, parts, saved, record_function):
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for label, (cls, names) in parts.items():
            for name in names:
                orig = getattr(cls, name)

                def wrapped(*a, _orig=orig, _label=label, **k):
                    with record_function(f"qrag::{_label}"):
                        return _orig(*a, **k)

                saved.append((cls, name, orig))
                setattr(cls, name, wrapped)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / calls

        def device_ms(ev):
            us = getattr(ev, "device_time_total", None)
            return (ev.cuda_time_total if us is None else us) / 1e3

        def range_of(ev):
            while ev is not None and not ev.name.startswith("qrag::"):
                ev = ev.cpu_parent
            return ev and ev.name[6:]

        events = prof.events()
        # a backward node's evaluation carries the sequence number of the
        # forward op that made the node
        made_in = {}
        for ev in events:
            if (ev.device_type != DeviceType.CUDA and ev.sequence_nr >= 0
                    and not ev.name.startswith("autograd::")):
                label = range_of(ev)
                if label:
                    made_in[ev.sequence_nr] = label
        busy = 0.0
        split = {label: 0.0 for label in parts}
        by_kernel = {}
        n_kernels = 0
        for ev in events:
            if ev.device_type == DeviceType.CUDA:
                # the ranges show twice: as CPU ops whose device time is
                # that of the kernels they launched, and as device-side
                # annotations, which are no kernels
                if not ev.name.startswith("qrag::"):
                    us = ev.time_range.elapsed_us()
                    busy += us / 1e3
                    n_kernels += 1
                    by_kernel[ev.name[:48]] = by_kernel.get(ev.name[:48], 0.0) + us / 1e3
            elif ev.name.startswith("qrag::"):
                split[ev.name[6:]] += device_ms(ev)
            elif ev.name.startswith("autograd::engine::evaluate_function"):
                if ev.sequence_nr in made_in:
                    split[made_in[ev.sequence_nr]] += device_ms(ev)
            elif ev.name.startswith("Optimizer.step"):
                split["optimizer"] = split.get("optimizer", 0.0) + device_ms(ev)
        if busy <= 0.0:
            return {"profile": "not measured (the profiler saw no device time)"}
        split = {k: round(v / calls, 4) for k, v in split.items()}
        split["elementwise_and_rest"] = round(busy / calls - sum(split.values()), 4)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        return {"profiled_wall_ms": wall, "device_busy_ms": busy / calls,
                "idle_share": 1.0 - busy / calls / wall, "device_ms_by_part": split,
                "kernels_per_call": n_kernels / calls,
                "top_kernels_ms": [(name, round(ms / calls, 4)) for name, ms in top]}

    def model_timings(self, chunks, models):
        """Texts/s of the bi-encoder, pairs/s of the cross-encoder (the
        shipped weights at 32 x 224, the default geometry at 32 x 256):
        ``ms`` from CUDA events, the host's tokenization apart, a
        profiler split, each beside its FLOP bound."""
        torch = self.torch
        from qrag_tpu_torch.models import bi_encoder as be
        from qrag_tpu_torch.models import cross_encoder as ce
        from qrag_tpu_torch.pipeline import corpus_gen

        rng = np.random.RandomState(3)
        texts = [c.text for c in chunks[:8192]]
        emb = models["embedder"]
        t0 = time.perf_counter()
        tokens, mask = be.tokenize_texts(texts[:64], emb.cfg.tower.max_len)
        tok_ms = 1e3 * (time.perf_counter() - t0)
        mask[:, 0] = 1.0
        t0 = time.perf_counter()
        emb(texts)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        ms = self._events_ms(lambda: emb.encode(tokens, mask), 20)
        flops = _model_flops(emb.cfg.tower, emb.cfg.tower.max_len, passes=1) * 64
        row = {"batch": "64 x 128 tokens", "ms": ms, "texts_per_s": 64e3 / ms,
               "end_to_end_texts_per_s": len(texts) / e2e_s, "host_tokenize_ms": tok_ms,
               "gflop": flops / 1e9, "bound_ms": 1e3 * flops / BF16_FLOPS_S,
               **self._model_profile(lambda: emb.encode(tokens, mask), 10)}
        print(f"timing [{self.card}]: bi-encoder (shipped) {row}", flush=True)
        query = corpus_gen.make_query(chunks[5], rng)
        docs = [chunks[int(i)].text for i in rng.randint(len(chunks), size=32)]
        default = ce.CrossEncoderScorer(seed=0, device=self.dev)
        for label, scorer in (("shipped, interaction", models["scorer"]),
                              ("default geometry, cls, random init", default)):
            t0 = time.perf_counter()
            tokens, mask = ce.tokenize_batch(query, docs, scorer.cfg.max_len)
            tok_ms = 1e3 * (time.perf_counter() - t0)
            cfg = scorer.cfg
            passes = 2 if cfg.head_type == "interaction" else 1
            ms = self._events_ms(lambda: scorer.logits(tokens, mask), 20)
            score_ms = self._events_ms(lambda: scorer.score(query, docs), 5)
            flops = _model_flops(cfg, cfg.max_len, passes) * len(docs)
            row = {"batch": f"{len(docs)} x {cfg.max_len} tokens", "dtype": str(scorer.dtype),
                   "ms": ms, "pairs_per_s": len(docs) * 1e3 / ms, "score_call_ms": score_ms,
                   "host_tokenize_ms": tok_ms, "gflop": flops / 1e9,
                   "bound_ms": 1e3 * flops / BF16_FLOPS_S,
                   **self._model_profile(lambda: scorer.logits(tokens, mask), 10)}
            print(f"timing [{self.card}]: cross-encoder ({label}) {row}", flush=True)

    # -------------------------------------------------------------- phase 8

    def train_path(self):
        """Training on the card at the shipped recipes' width: the
        cross-encoder's listwise fine-tune (Q=64: 4,096 pairs x 224
        tokens, warm-started from ``artifacts/bi_encoder``), the
        bi-encoder's InfoNCE (128 + 128 texts x 128 tokens), the train
        CLI with ``--remat`` and ``--resume``, and distillation with both
        artifacts."""
        t0 = time.perf_counter()
        self._free()
        self.rerank_training()
        self._free()
        self.recall_training()
        self._free()
        self.cli_training()
        self.distill_training()
        self._free()
        print(f"phase 8 (training): {time.perf_counter() - t0:.1f} s", flush=True)

    def _step_vs_cpu(self, label, build, loss_of, batch, rel_grad=1e-3, atol=1e-6):
        """(a) One f32 step from one state and one batch on the card and
        on the CPU: the loss within rtol 1e-4, each gradient leaf within
        ``rel_grad`` of that leaf's largest entry plus ``atol`` (the
        parity tests' form: a leaf whose exact gradient is zero, like the
        CLS head at the warm start under a listwise softmax, holds f32
        noise on both sides)."""
        torch = self.torch
        cpu = torch.device("cpu")
        out = {}
        for dev in (self.dev, cpu):
            model = build(dev)
            loss = loss_of(model, [t.to(dev) for t in batch], torch.float32)
            loss.backward()
            out[dev.type] = (float(loss.detach()), {n: p.grad.detach().to(cpu, torch.float64)
                                           for n, p in model.named_parameters()})
            del model, loss
        (card_loss, card_g), (cpu_loss, cpu_g) = out[self.dev.type], out["cpu"]
        # per leaf: (max |diff|, max |CPU entry|)
        leaves = {n: (float((card_g[n] - g).abs().max()), float(g.abs().max()))
                  for n, g in cpu_g.items()}
        bad = [n for n, (err, scale) in leaves.items() if err > rel_grad * scale + atol]
        # leaves whose largest entry is under atol / rel_grad hold f32
        # noise (a gradient zero in exact arithmetic): atol judges them
        held = {n: err / scale for n, (err, scale) in leaves.items() if rel_grad * scale > atol}
        noise = sorted(set(leaves) - set(held))
        worst = max(held, key=held.get)
        loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        print(f"{label} (a) card f32 vs CPU f32, one step: loss {card_loss:.8f} vs "
              f"{cpu_loss:.8f} (rel {loss_rel:.2e}, tolerance 1e-4); {len(held)} gradient "
              f"leaves within {rel_grad} of their own largest entry: largest relative error "
              f"{held[worst]:.2e} ({worst}); {len(noise)} at f32 noise {noise}, max |diff| "
              f"{max([leaves[n][0] for n in noise], default=0.0):.3e} (atol {atol})",
              flush=True)
        if not (loss_rel <= 1e-4 and not bad):
            raise AssertionError(f"{label}: the card's f32 step differs from the CPU's "
                                 f"(leaves {bad})")

    def _bf16_vs_f32(self, label, build, loss_of, loss_rtol, cos_floor):
        """(b) The same step in bf16 and in f32 on the card
        (``ce.bf16_step_deviation``): the loss within ``loss_rtol`` of the
        f32 loss, the gradients' cosine at or above ``cos_floor`` (bounds
        fixed on the CPU, tests/test_torch_train.py); the peak memory of
        the pair."""
        torch = self.torch
        from qrag_tpu_torch.models import cross_encoder as ce

        torch.cuda.reset_peak_memory_stats()
        rel, cos = ce.bf16_step_deviation(build, loss_of)
        peak = torch.cuda.max_memory_allocated()
        print(f"{label} (b) card bf16 vs card f32, one step: loss rel {rel:.2e} (bound "
              f"{loss_rtol}); gradient cosine {cos:.6f} (floor {cos_floor}); peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        if not (rel <= loss_rtol and cos >= cos_floor):
            raise AssertionError(f"{label}: bf16 step beyond the CPU-fixed bounds")

    def _timed_steps(self, step, batches):
        """One ``step(*batch)`` per batch: per-step ms between CUDA
        events and the losses."""
        torch = self.torch
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(batches) + 1)]
        losses = []
        ev[0].record()
        for i, batch in enumerate(batches):
            losses.append(step(*batch))
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(len(batches))], [
            float(loss) for loss in losses]

    def _moved(self, label, before, after, gates=(), zero_grad=()):
        """(c) Every parameter leaf moved, the gates stayed finite
        (``zero_grad``: leaves whose gradient is zero in exact
        arithmetic, which may stay)."""
        still = [n for n in before
                 if n not in zero_grad and np.array_equal(before[n], after[n])]
        bad = [n for n in gates if not np.isfinite(after[n]).all()]
        if still or bad:
            raise AssertionError(f"{label}: unmoved {still}, non-finite gates {bad}")

    def rerank_training(self, steps=20, q=64):
        """The shipped cross-encoder's recipe (``rerank_eval
        --episodes 48 --extra-train-episodes 192``, warm start from
        ``artifacts/bi_encoder``, AdamW 3e-4 with decay 1e-4) at Q=64 with
        bf16 activations: checks (a)-(d), then step ms, pairs/s, peak
        memory, the FLOP bound, a profiler split and held-out nDCG@10."""
        import os
        import shutil
        import statistics
        import tempfile

        torch = self.torch
        from qrag_tpu_torch.config import ClassicalConfig
        from qrag_tpu_torch.models import cross_encoder as ce
        from qrag_tpu_torch.models import rerank_eval as rev
        from qrag_tpu_torch.models.weights import ordered_parameters
        from qrag_tpu_torch.pipeline import corpus_gen

        cfg = rev.RerankEvalConfig(steps=steps, batch=q, extra_train_episodes=192)
        chunks = corpus_gen.generate_corpus(cfg.n_episodes, cfg.chunks_per_episode, seed=cfg.seed)
        train_idx, hold_idx = corpus_gen.split_by_episode(chunks, cfg.holdout_frac,
                                                          seed=cfg.seed + 1)
        pool = chunks + corpus_gen.generate_corpus(cfg.extra_train_episodes,
                                                   cfg.chunks_per_episode, seed=cfg.seed + 201)
        fit_idx = list(train_idx) + list(range(len(chunks), len(pool)))
        ce_cfg = rev._make_cfg(cfg)
        warm = rev.warm_start_params(ce_cfg, rev.resolve_init_from(cfg.init_from))
        # the groups train_cross_encoder draws, tokenized on the host
        t0 = time.perf_counter()
        grids = rev.group_grids(cfg, pool, fit_idx, steps)
        tok_ms = 1e3 * (time.perf_counter() - t0) / steps

        def build(dev):
            return ce.trainable(ce.load_module(
                ce.CrossEncoder(ce_cfg, pos_rows=warm["pos_emb"].shape[0]), warm), dev)

        def loss_of(model, batch, dtype):
            return rev.listwise_loss(model, *batch, dtype)

        label = f"cross-encoder listwise (interaction, dim 128, 4 experts, {cfg.max_len} tokens)"
        # from the warm start and the first (hard) group of the timed
        # run: (a) on its first 4 query rows against all Q documents (the
        # rows of the listwise loss are independent; the whole group
        # would take the CPU minutes), (b) on the whole group
        toks, masks = grids[0]
        rows = min(4, q)
        self._step_vs_cpu(label, build, loss_of, list(ce.device_batch(
            torch.device("cpu"), toks[:rows], masks[:rows], np.zeros((rows, q)))))
        b16 = ce.device_batch(self.dev, toks, masks, np.zeros((q, q)))
        self._bf16_vs_f32(label, lambda: build(self.dev),
                          lambda m, dtype: rev.listwise_loss(m, *b16, dtype),
                          ce.BF16_STEP_LOSS_RTOL, ce.BF16_GRAD_COSINE_FLOOR)
        del b16
        self._free()

        # the run: 20 steps through the entry point
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scorer, trace = rev.train_cross_encoder(cfg, pool, fit_idx, device=self.dev)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        trained = scorer.params()
        if scorer.dtype != ce.default_dtype(self.dev) or not all(np.isfinite(v) for _, v in trace):
            raise AssertionError(f"{label}: {scorer.dtype}, trace {trace}")
        # the CLS bias shifts every logit of a softmax row alike
        self._moved(label, warm, trained, [f"layers.{i}.xgate" for i in range(ce_cfg.n_layers)],
                    zero_grad=("head.b",))
        print(f"{label} (c) train_cross_encoder Q={q} ({q * q} pairs a step) on {self.dev}: "
              f"{steps} steps in {run_s:.2f} s (host group draw + tokenization {tok_ms:.1f} ms "
              f"a step), "
              f"trace {trace}, every leaf moved, xgate "
              f"{[float(trained[f'layers.{i}.xgate']) for i in range(ce_cfg.n_layers)]}; "
              f"peak memory {peak / 2**30:.2f} GiB", flush=True)

        # (d) saved and loaded through the reranker's cache layout
        tmp = tempfile.mkdtemp(prefix="qrag_train_")
        try:
            scorer.save(os.path.join(tmp, "cross_encoder"))
            loaded = ce.CrossEncoderScorer.from_config(
                ClassicalConfig(method="cross-encoder", model_cache_dir=tmp,
                                model_name="cross_encoder"), device=self.dev)
            rng = np.random.RandomState(5)
            query = corpus_gen.make_query(chunks[int(hold_idx[0])], rng)
            docs = [pool[int(i)].text for i in rng.randint(len(pool), size=100)]
            diff = float(np.abs(loaded.score(query, docs) - scorer.score(query, docs)).max())
            if loaded.cfg != ce_cfg or diff > 1e-6:
                raise AssertionError(f"{label}: loaded scorer {loaded.cfg}, max diff {diff}")
            print(f"{label} (d) saved + loaded via CrossEncoderScorer.from_config: 100 pairs, "
                  f"max |score diff| to the live module {diff:.2e}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # held-out quality beside the step-0 warm start (reported)
        cases = rev._eval_cases(cfg, chunks, hold_idx)
        warm_scorer = ce.CrossEncoderScorer(ce_cfg, params=warm, device=self.dev)
        quality = {f"after_{steps}_steps": rev.eval_ranker(scorer.score, chunks, cases),
                   "warm_start_step0": rev.eval_ranker(warm_scorer.score, chunks, cases)}
        print(f"{label}: held-out rerank quality over {len(cases)} cases x "
              f"{cfg.candidates} candidates {quality}", flush=True)
        del scorer, loaded, warm_scorer
        self._free()

        # timing: the same 20 steps again from the warm start, batches
        # already on the card
        model = build(self.dev)
        opt = torch.optim.AdamW(ordered_parameters(model, ce_cfg), lr=cfg.lr,
                                weight_decay=ce.ADAMW_DECAY)
        step = rev.make_listwise_step(model, opt, ce.default_dtype(self.dev))
        teacher = torch.zeros((q, q), device=self.dev)
        batches = [(*ce.device_batch(self.dev, t, m), teacher) for t, m in grids]
        torch.cuda.reset_peak_memory_stats()
        ms, losses = self._timed_steps(step, batches)
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)) or abs(losses[0] - trace[0][1]) > 1e-3 * abs(
                trace[0][1]) + 1e-6:
            raise AssertionError(f"{label}: timing-run losses {losses} vs trace {trace}")
        step_ms = statistics.median(ms[4:])
        flops = 3 * _model_flops(ce_cfg, cfg.max_len, passes=2) * q * q
        row = {"step_ms_median_5_20": step_ms, "step_ms": [round(m, 2) for m in ms],
               "pairs_per_s": q * q * 1e3 / step_ms, "peak_memory_gib": peak / 2**30,
               "tflop_per_step": flops / 1e12, "flop_bound_ms": 1e3 * flops / BF16_FLOPS_S,
               "share_of_bound": 1e3 * flops / BF16_FLOPS_S / step_ms,
               "host_draw_tokenize_ms_per_step": tok_ms,
               "losses": [round(x, 5) for x in losses],
               **self._model_profile(lambda: step(*batches[0]), 3)}
        print(f"timing [{self.card}]: cross-encoder train step Q={q} ({q * q} pairs x "
              f"{cfg.max_len} tokens, bf16) {row}", flush=True)
        del model, opt, step, batches

    def recall_training(self, steps=50, timed=20):
        """The shipped bi-encoder's recipe (``recall_eval``: batch 128, 128
        tokens, dim 128, 4 heads, 2 layers, 4 experts, ``out_dim`` 128,
        Adam 1e-3) for 50 steps: checks (a)-(c), recall@10, texts/s."""
        import statistics

        torch = self.torch
        from qrag_tpu_torch.models import bi_encoder as be
        from qrag_tpu_torch.models import cross_encoder as ce
        from qrag_tpu_torch.models import recall_eval as rcl
        from qrag_tpu_torch.models.weights import ordered_parameters
        from qrag_tpu_torch.pipeline import corpus_gen

        cfg = rcl.RecallEvalConfig(batch=128, steps=steps)
        chunks = corpus_gen.generate_corpus(cfg.n_episodes, cfg.chunks_per_episode, seed=cfg.seed)
        train_idx, hold_idx = corpus_gen.split_by_episode(chunks, cfg.holdout_frac,
                                                          seed=cfg.seed + 1)
        pairs = corpus_gen.training_pairs(chunks, train_idx, n_pairs=steps * cfg.batch,
                                          seed=cfg.seed + 2)
        bi_cfg = rcl._bi_config(cfg)
        init = be.init_params(bi_cfg, cfg.seed)
        texts = [(be.tokenize_texts(qs, cfg.max_len), be.tokenize_texts(ds, cfg.max_len))
                 for qs, ds in rcl._doc_batches(cfg, pairs)][:timed]

        def build(dev):
            return ce.trainable(ce.load_module(be.BiEncoder(bi_cfg), init), dev)

        def loss_of(model, batch, dtype):
            return be.info_nce_loss(model, *batch, dtype)

        label = f"bi-encoder InfoNCE ({cfg.batch} + {cfg.batch} texts x {cfg.max_len} tokens)"
        (qt, qm), (dt, dm) = texts[0]
        cpu = self.torch.device("cpu")
        self._step_vs_cpu(label, build, loss_of,
                          [*ce.device_batch(cpu, qt, qm), *ce.device_batch(cpu, dt, dm)])
        batch = [*ce.device_batch(self.dev, qt, qm), *ce.device_batch(self.dev, dt, dm)]
        self._bf16_vs_f32(label, lambda: build(self.dev), lambda m, dtype: loss_of(m, batch, dtype),
                          be.BF16_STEP_LOSS_RTOL, be.BF16_GRAD_COSINE_FLOOR)
        t0 = time.perf_counter()
        embedder, trace = rcl.train_bi_encoder(cfg, pairs, device=self.dev)
        run_s = time.perf_counter() - t0
        if embedder.dtype != ce.default_dtype(self.dev) or not all(
                np.isfinite(v) for _, v in trace):
            raise AssertionError(f"{label}: {embedder.dtype}, trace {trace}")
        self._moved(label, init, embedder.params())
        recall = rcl.recall_at_k(embedder, chunks, hold_idx, cfg.k, cfg.queries_per_chunk,
                                 device=self.dev)
        print(f"{label} (c) train_bi_encoder on {self.dev}: {steps} steps in {run_s:.2f} s, "
              f"trace {trace}, every leaf moved; held-out recall@{cfg.k} {recall:.4f}",
              flush=True)
        model = build(self.dev)
        step = be.make_train_step(model, torch.optim.Adam(ordered_parameters(model, bi_cfg),
                                                          lr=cfg.lr), ce.default_dtype(self.dev))
        batches = [(*ce.device_batch(self.dev, qt, qm), *ce.device_batch(self.dev, dt, dm))
                   for (qt, qm), (dt, dm) in texts]
        ms, losses = self._timed_steps(step, batches)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{label}: timing-run losses {losses}")
        step_ms = statistics.median(ms[4:])
        flops = 3 * _model_flops(bi_cfg.tower, cfg.max_len, passes=1) * 2 * cfg.batch
        row = {"step_ms_median_5_20": step_ms, "texts_per_s": 2 * cfg.batch * 1e3 / step_ms,
               "gflop_per_step": flops / 1e9, "flop_bound_ms": 1e3 * flops / BF16_FLOPS_S,
               **self._model_profile(lambda: step(*batches[0]), 5)}
        print(f"timing [{self.card}]: bi-encoder train step {row}", flush=True)

    def cli_training(self):
        """``train_cli --device cuda --steps 40 --remat`` with the CLI's
        defaults, then ``--resume`` for 20 more; the weights score
        through ``ClassicalReranker(method="cross-encoder")``."""
        import io
        import os
        import shutil
        import statistics
        import tempfile

        torch = self.torch
        from qrag_tpu_torch.config import ClassicalConfig
        from qrag_tpu_torch.documents import Document
        from qrag_tpu_torch.models import train_cli
        from qrag_tpu_torch.models.cross_encoder import CrossEncoderConfig, default_dtype
        from qrag_tpu_torch.parallel.train import make_trainer, synthetic_batch
        from qrag_tpu_torch.reranker.classical import ClassicalReranker

        tmp = tempfile.mkdtemp(prefix="qrag_cli_")
        try:
            out = os.path.join(tmp, "cli-cross-encoder")
            args = ["--device", self.dev.type, "--remat", "--out", out]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                train_cli.main(args + ["--steps", "40"])
                train_cli.main(args + ["--steps", "20", "--resume", out + ".ckpt"])
            cli_s = time.perf_counter() - t0
            log = buf.getvalue()
            with open(os.path.join(out + ".ckpt", "config.json")) as f:
                meta = json.load(f)
            on = "cuda:0" if self.dev.type == "cuda" else "cpu"
            expect = (f"device: {on} (single device)", f"resumed from {out}.ckpt at step 40",
                      "trained to step 60")
            dtype = str(default_dtype(self.dev)).removeprefix("torch.")
            if not all(e in log for e in expect) or meta["step"] != 60 or not (
                    meta["config"]["remat"] and meta["config"]["dtype"] == dtype):
                raise AssertionError(f"train_cli: {log} {meta}")
            rr = ClassicalReranker(ClassicalConfig(method="cross-encoder", model_cache_dir=tmp,
                                                   model_name="cli-cross-encoder"),
                                   device=self.dev)
            docs = [Document(str(i), t) for i, t in enumerate(
                ["podcast sponsor deal offer", "climate news debate", "music guest interview",
                 "sponsor podcast advert", "money health sport"])]
            ranked = rr.rerank("sponsor podcast deal", docs, top_k=5)
            if rr._active_method != "cross-encoder" or rr._cross_encoder.forward_calls < 1 or not all(
                    0.0 < s < 1.0 for _, s in ranked):
                raise AssertionError(f"train_cli weights: {rr._active_method} {ranked}")
            lines = [ln for ln in log.splitlines() if ln.startswith(("step", "resumed"))]
            print(f"train_cli --device {self.dev.type} --remat (defaults: 32 x 128, dim 128, "
                  f"cls head): "
                  f"40 + 20 resumed steps in {cli_s:.1f} s, {lines}; ClassicalReranker "
                  f"cross-encoder order {[d.id for d, _ in ranked]}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        cfg = CrossEncoderConfig(dim=128, n_heads=4, n_layers=2, n_experts=4, max_len=128)
        _, _, step = make_trainer(cfg, device=self.dev, remat=True)
        rng = np.random.RandomState(0)
        batches = [synthetic_batch(rng, 32, cfg.max_len) for _ in range(20)]
        ms, losses = self._timed_steps(step, batches)
        step_ms = statistics.median(ms[4:])
        flops = 3 * _model_flops(cfg, cfg.max_len, passes=1) * 32
        row = {"step_ms_median_5_20": step_ms, "pairs_per_s": 32e3 / step_ms,
               "gflop_per_step": flops / 1e9, "flop_bound_ms": 1e3 * flops / BF16_FLOPS_S,
               **self._model_profile(lambda: step(*batches[0]), 5, parts={})}
        print(f"timing [{self.card}]: train_cli step (32 x 128, remat, host batches) {row}",
              flush=True)

    def distill_training(self):
        """``distill`` for 10 steps, the student warm-started from and
        taught by ``artifacts/bi_encoder`` (its geometry)."""
        from qrag_tpu_torch.models import distill

        t0 = time.perf_counter()
        out, _, ce_cfg = distill.distill(distill.DistillConfig(
            steps=10, dim=128, heads=4, layers=2, n_experts=4, max_len=128,
            teacher_weights="artifacts/bi_encoder", init_from="artifacts/bi_encoder"),
            device=self.dev)
        if not all(np.isfinite(v) for _, v in out["loss_trace"]):
            raise AssertionError(f"distill: {out}")
        print(f"distill on {self.dev} (student {ce_cfg.head_type}, dim {ce_cfg.dim}), 10 steps "
              f"in {time.perf_counter() - t0:.1f} s: {out}", flush=True)

    # -------------------------------------------------------------- phase 9

    def accel_quantum_path(self):
        """Phase 9: the small-batch clustered accelerator over a clustered
        1,048,576 x 768 corpus (exactness, timings against the bounded
        path, the probe arm's recall, the served rerank) and the full
        quantum paths on it, the accelerator's ladder over uniform rows,
        and the native host store.  Returns the kernel launches of the
        accelerator's and the quantum paths' runs (none of them runs a
        kernel of ``csrc/``: 0 expected)."""
        t0 = time.perf_counter()
        self._free()
        launches = self.accel_path()
        self._free()
        self.ladder_path()
        self._free()
        self.native_store_path()
        print(f"phase 9 (accelerator, native store, quantum paths): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return launches

    def _all_launches(self, reset=False):
        """Every hand-written kernel's launch count, under the keys of
        the kernels line; ``reset`` sets them to 0 instead."""
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.cuda import gather_rows as cg
        from qrag_tpu_torch.ops.cuda import scan_topk as ct

        if reset:
            fused_scan.reset_launches()
            cg.reset_launches()
            ct.reset_launches()
            return None
        return {**dict(fused_scan.launches), "gather_rows": cg.launches,
                **{("scan_topk", arm): n for arm, n in ct.launches.items()}}

    def _mixture(self, n, d, seed):
        """``bench.py``'s clustered recipe on the card: max(16, n/4096)
        unit centers, spread 0.25/sqrt(d), unit rows; returns the rows
        and a query maker (the same centers, other draws)."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        n_centers = max(16, n // (512 * 8))
        spread = 0.25 / float(np.sqrt(d))
        centers = torch.randn((n_centers, d), generator=g, device=self.dev)
        centers /= centers.norm(dim=1, keepdim=True)

        def draw(m):
            which = torch.randint(0, n_centers, (m,), generator=g, device=self.dev)
            x = centers[which] + spread * torch.randn((m, d), generator=g, device=self.dev)
            return x / x.norm(dim=1, keepdim=True)

        x = draw(n)
        return x, lambda m: draw(m).cpu().numpy()

    def _check_accel(self, snap, q, idx, vals, k):
        """Accelerator results (ORIGINAL indices, goodness) against the
        f32 oracle of the stored rows under the exactness contract;
        returns the sub-noise tie reorders."""
        from qrag_tpu_torch.ops.topk import _goodness

        qt, ov, oi = self._oracle(snap, q, k)
        g = _goodness(qt, snap.matrix, "l2", snap.sqnorms, snap.valid)
        return _check_exact(idx.to(self.dev), vals.to(self.dev), oi, ov, g, atol=1e-4)

    def accel_path(self, n=1 << 20, d=768):
        """(a) the clustered corpus: build, exactness at B = 1..16 (k=10)
        and B=1 (k=100) through ``index.search``, B = 32 and 64 through
        the op; (c) probe recall; (d) the served rerank; (f) the quantum
        paths; then the timings against the bounded path."""
        torch = self.torch
        from qrag_tpu_torch.config import QragConfig
        from qrag_tpu_torch.engine import QragEngine
        from qrag_tpu_torch.ops import cluster_topk as ct

        t0 = time.perf_counter()
        x, queries = self._mixture(n, d, seed=42)
        x_host = x.cpu().numpy()
        del x
        cfg = {"embedding": {"provider": "hash", "dim": d},
               "index": {"small_batch_accel": "clustered"}}
        engine = QragEngine(config=QragConfig.from_dict(cfg), device=self.dev)
        index = engine.index
        index.add(x_host)
        del x_host
        snap = index.device_buffers()
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        groups = index.build_clustered()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        g_count, L = groups.centroids.shape[0], groups.group_rows
        S = ct._auto_budget(10, L)
        print(f"(a) clustered corpus [{self.card}]: {n:,} x {d} f32 unit rows "
              f"({max(16, n // 4096)} centers, spread 0.25/sqrt(d)), setup {setup_s:.1f} s; "
              f"accelerator build {build_s:.2f} s (k-means + permutation + stats): "
              f"G={g_count} groups of L={L}, {groups.corpus_p.shape[0]:,} permuted rows, "
              f"{int(groups.group_valid.sum())} valid groups, S={S} at k=10; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

        # the accelerator's main path: index.search and the served
        # rerank, counts set to 0 just before and read just after
        self._all_launches(reset=True)
        ties, esc0, fb0 = 0, index.cluster_escalations, index.cluster_fallbacks
        for b, k, reps in ((1, 10, 8), (4, 10, 4), (8, 10, 4), (16, 10, 4), (1, 100, 4)):
            for _ in range(reps):
                q = queries(b)
                res = index.search(q, k)
                ties += self._check_accel(snap, q, torch.from_numpy(res.indices).long(),
                                          -torch.from_numpy(res.scores), k)
        esc, fb = index.cluster_escalations - esc0, index.cluster_fallbacks - fb0
        launches = {("accel", key): v for key, v in self.accel_served(engine, snap, queries).items()}
        print(f"(a) index.search through the accelerator: 8 x B=1, 4 x B=4, 4 x B=8, "
              f"4 x B=16 (k=10) and 4 x B=1 (k=100): identity equal to the f32 oracle "
              f"(sub-noise tie reorders {ties}); escalations {esc}, fallbacks {fb} of 24 "
              f"batches; kernel launches on the accelerator's path {launches}", flush=True)
        for b in (32, 64):  # past accel_max_batch: through the op
            q = queries(b)
            vals, idx, fbk, escb = ct.cluster_pruned_topk(torch.from_numpy(q).to(self.dev), groups, 10)
            t = self._check_accel(snap, q, idx, vals, 10)
            print(f"(a) cluster_pruned_topk B={b} k=10: equal to the f32 oracle (tie reorders "
                  f"{t}); escalated {escb}, fell back {fbk}", flush=True)
        self.probe_recall(snap, groups, queries)
        launches.update(self.quantum_paths(index, queries))
        self.accel_timings(index, queries, g_count, L, d)
        del engine, index, snap, groups
        return launches

    def accel_served(self, engine, snap, queries):
        """(d) /search_rerank B=1 candidates=100 through ``create_server``
        with the accelerator: the candidates equal the bounded engine's,
        and /stats carries the accelerator's counters.  Returns the
        kernel launches counted up to the accelerator's request (the
        bounded comparison after it is not the accelerator's path)."""
        torch = self.torch
        from qrag_tpu_torch.engine import _fused_candidates

        index = engine.index
        q = queries(1)
        with self._serve(engine) as port:
            accel = _post(port, "/search_rerank", {"vectors": q.tolist(), "k": 10, "candidates": 100})
            stats = _get(port, "/stats")["index"]
            launched = self._all_launches()
            index.small_batch_accel = "none"  # the same engine on the bounded path
            try:
                bounded = _post(port, "/search_rerank", {"vectors": q.tolist(), "k": 10,
                                                         "candidates": 100})
            finally:
                index.small_batch_accel = "clustered"
        qd = torch.from_numpy(q).to(self.dev)
        mode, kw = engine._fused_candidate_mode(100, snap, batch=1)
        mode_b, kw_b = engine._fused_candidate_mode(100, snap)
        if (mode, mode_b) != ("clustered", "bounded"):
            raise AssertionError(f"candidate modes {mode}, {mode_b}")
        args = (qd, snap.matrix, snap.sqnorms, snap.valid, 100, "l2")
        ra, ca = _fused_candidates(*args, mode, **kw)
        rb, cb = _fused_candidates(*args, mode_b, **kw_b)
        ties = self._check_accel(snap, q, ca, -ra, 100)
        if not torch.equal(ca, cb):
            raise AssertionError("the accelerator's candidates differ from the bounded engine's")
        got = [[h["index"] for h in r] for r in accel["results"]]
        want = [[h["index"] for h in r] for r in bounded["results"]]
        if got != want or accel["reranker_used"] != "quantum":
            raise AssertionError(f"/search_rerank with the accelerator {got} != bounded {want}")
        np.testing.assert_allclose([h["score"] for h in accel["results"][0]],
                                   [h["score"] for h in bounded["results"][0]], rtol=0, atol=1e-7)
        keys = ("small_batch_accel", "cluster_escalations", "cluster_fallbacks")
        if stats.get("small_batch_accel") != "clustered" or not all(k in stats for k in keys):
            raise AssertionError(f"/stats: {stats}")
        print(f"(d) served /search_rerank B=1 k=10 candidates=100 with small_batch_accel="
              f"clustered: candidates equal to the bounded engine's (and the f32 oracle's "
              f"top-100, tie reorders {ties}), reranked top-10 equal; /stats "
              f"{ {k: stats[k] for k in keys} }", flush=True)
        return launched

    def probe_recall(self, snap, groups, queries):
        """(c) ``clustered_probe`` (no certificates) recall@10 against the
        f32 oracle at budgets 8, 20, 80, over 64 queries."""
        torch = self.torch
        from qrag_tpu_torch.ops import cluster_topk as ct

        q = queries(64)
        qd = torch.from_numpy(q).to(self.dev)
        _, _, oi = self._oracle(snap, q, 10)
        truth = oi.cpu().numpy()
        rows = []
        for budget in (8, 20, 80):
            _, idx, _, _ = ct.cluster_pruned_topk(qd, groups, 10, budget=budget, certify=False)
            ms = self._events_ms(
                lambda: ct.cluster_pruned_topk(qd[:1], groups, 10, budget=budget, certify=False), 20)
            rows.append((budget, _recall(idx.cpu().numpy(), truth), ms))
        print(f"(c) clustered_probe recall@10 over 64 queries [{self.card}] (budget, recall, "
              f"B=1 ms): {[(s, round(r, 4), round(m, 3)) for s, r, m in rows]}", flush=True)

    def accel_timings(self, index, queries, g_count, L, d, reps=10):
        """Per B: ``index.search`` k=10 through the accelerator against the
        same index on the bounded path (the scan kernel's arm named), in
        turns bounded, accel, accel, bounded; the accelerator's group
        read (B*S*L*d*4 bytes) beside its bound at the card's memory
        rate; a ``torch.profiler`` busy time and idle share at B=1, 16; the
        crossover B against accel_max_batch=16."""
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops import cluster_topk as ct

        S = ct._auto_budget(10, L)
        saved = (index.accel_max_batch, index.accel_read_cap)
        index.accel_max_batch, index.accel_read_cap = 64, 0.0
        rows = []
        try:
            for b in (1, 4, 8, 16, 32, 64):
                qs = [queries(b) for _ in range(reps)]

                def run(mode):
                    index.small_batch_accel = mode
                    try:
                        t0 = time.perf_counter()
                        for q in qs:
                            index.search(q, 10)
                        return 1e3 * (time.perf_counter() - t0) / reps
                    finally:
                        index.small_batch_accel = "clustered"

                run("clustered")
                arms = dict(fused_scan.arm_launches)
                run("none")
                arm = [a for a, c in fused_scan.arm_launches.items() if c != arms[a]]
                esc0 = index.cluster_escalations
                turns = [run("none"), run("clustered"), run("clustered"), run("none")]
                bounded_ms = float(np.median([turns[0], turns[3]]))
                accel_ms = float(np.median([turns[1], turns[2]]))
                read = b * S * L * d * 4
                rows.append((b, accel_ms, bounded_ms, arm, read, 1e3 * read / HBM_BYTES_S,
                             index.cluster_escalations - esc0))
        finally:
            index.accel_max_batch, index.accel_read_cap = saved
            index.small_batch_accel = "clustered"
        for b, a, bd, arm, read, bound, esc in rows:
            print(f"timing [{self.card}]: index.search B={b} k=10 accelerator {a:.3f} ms vs "
                  f"bounded ({'/'.join(arm)} arm) {bd:.3f} ms, ratio {bd / a:.2f}x; group read "
                  f"{read / 1e6:.1f} MB (S={S}, L={L}) bound {bound:.4f} ms at 3.35 TB/s; "
                  f"escalations in {2 * reps} timed calls: {esc}", flush=True)
        cross = next((f"from B={b}" for b, a, bd, *_ in rows if a >= bd), "at no B up to 64")
        print(f"crossover [{self.card}]: the accelerator is as slow as the bounded path or "
              f"slower {cross} (accel_max_batch=16)", flush=True)
        for b in (1, 16):
            self._accel_profile(index, queries, b)

    def _accel_profile(self, index, queries, b, calls=10):
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        qs = [queries(b) for _ in range(calls)]
        index.search(qs[0], 10)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for q in qs:
                index.search(q, 10)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / calls
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
        if not by_name:
            print(f"profile accelerator B={b}: not measured (the profiler saw no device time)")
            return
        busy = sum(by_name.values()) / calls
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile [{self.card}]: accelerator index.search B={b} k=10, {calls} calls: wall "
              f"{wall:.3f} ms/call, device busy {busy:.3f} ms/call, idle share "
              f"{1 - busy / wall:.2f}; {sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA) // calls} "
              f"device ops/call; device ms/call by kernel: "
              f"{[(name[:60], round(ms / calls, 4)) for name, ms in top]}", flush=True)

    def ladder_path(self, n=1 << 20, d=768):
        """(b) the accelerator over uniform unit rows: nothing prunes, so
        every batch takes the ladder (tier 1, the 4x tier, the chunked
        f32 fallback) and must stay exact; escalations and fallbacks
        counted."""
        torch = self.torch
        from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

        g = torch.Generator(device=self.dev).manual_seed(7)
        x = torch.randn((n, d), generator=g, device=self.dev)
        x /= x.norm(dim=1, keepdim=True)
        x_host = x.cpu().numpy()
        del x
        index = DeviceFlatIndex.from_numpy(x_host, small_batch_accel="clustered", device=self.dev)
        del x_host
        snap = index.device_buffers()
        t0 = time.perf_counter()
        index.build_clustered()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        qrng = np.random.default_rng(9)
        ties, ms = 0, []
        for b in (1, 1, 4, 16):
            q = qrng.standard_normal((b, d), dtype=np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            t1 = time.perf_counter()
            res = index.search(q, 10)
            ms.append((b, round(1e3 * (time.perf_counter() - t1), 3)))
            ties += self._check_accel(snap, q, torch.from_numpy(res.indices).long(),
                                      -torch.from_numpy(res.scores), 10)
        print(f"(b) ladder [{self.card}]: {n:,} x {d} uniform unit rows, build {build_s:.2f} s; "
              f"B=1, 1, 4, 16 k=10 equal to the f32 oracle (tie reorders {ties}); "
              f"escalations {index.cluster_escalations}, fallbacks {index.cluster_fallbacks} "
              f"of 4 batches; host ms per search {ms}", flush=True)
        if index.cluster_fallbacks < 1:
            print("(b) note: no batch fell back on uniform rows")
        del index, snap

    def native_store_path(self, n=200_000, d=256):
        """(e) the native host store at the reference's host-tier size:
        ``scan_topk`` and ``cluster_topk`` give the same identity, and
        ``to_device_index().search`` on the card equals both; host ms."""
        import shutil
        import tempfile

        torch = self.torch
        from qrag_tpu_torch.index import native_store as ns
        from qrag_tpu_torch.ops.topk import _goodness

        t0 = time.perf_counter()
        ns.load_library()
        build_s = time.perf_counter() - t0
        x, queries = self._mixture(n, d, seed=11)
        x = x.cpu().numpy()
        tmp = tempfile.mkdtemp(prefix="qrag_store_")
        try:
            with ns.NativeVectorStore(f"{tmp}/store.qidx", d=d, metric="l2") as store:
                store.append(x)
                t1 = time.perf_counter()
                clusters = store.build_clusters(rows_per_cluster=1024)
                clusters_s = time.perf_counter() - t1
                rows, ties = [], 0
                device_index = store.to_device_index(device=self.dev)
                for b in (1, 8):
                    q = queries(b)
                    scan_ms, clus_ms = [], []
                    for _ in range(5):
                        t1 = time.perf_counter()
                        s0, i0 = store.scan_topk(q, 10)
                        scan_ms.append(1e3 * (time.perf_counter() - t1))
                        t1 = time.perf_counter()
                        s1, i1, stats = store.cluster_topk(q, 10, clusters=clusters)
                        clus_ms.append(1e3 * (time.perf_counter() - t1))
                    if not np.array_equal(i0, i1):
                        raise AssertionError(f"native cluster_topk != scan_topk at B={b}")
                    res = device_index.search(q, 10)
                    dsnap = device_index.device_buffers()
                    qt = torch.from_numpy(q).to(self.dev)
                    g = _goodness(qt, dsnap.matrix, "l2", dsnap.sqnorms, dsnap.valid)
                    ov = -torch.from_numpy(s0).to(self.dev)
                    ties += _check_exact(torch.from_numpy(res.indices).to(self.dev),
                                         -torch.from_numpy(res.scores).to(self.dev),
                                         torch.from_numpy(i0).to(self.dev), ov, g, atol=1e-4)
                    rows.append((b, float(np.median(scan_ms)), float(np.median(clus_ms)),
                                 stats.tolist()))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"(e) native store [{self.card} host]: g++ build {build_s:.1f} s; {n:,} x {d} "
              f"mixture, host clusters G={clusters.cent.shape[0]} in {clusters_s:.1f} s; "
              f"cluster_topk identity == scan_topk; to_device_index().search on {self.dev} "
              f"equal (sub-noise tie reorders {ties}); host ms median of 5, single thread "
              f"(B, scan_topk, cluster_topk, [fallback, escalated] queries): "
              f"{[(b, round(s, 3), round(c, 3), st) for b, s, c, st in rows]}", flush=True)

    def quantum_paths(self, index, queries):
        """(f) the full quantum paths on the clustered corpus: the fused
        /search_rerank B=64 C=100 with the full statevector at n_qubits
        4, 10 and 16 against the analytic path (same top-10, fidelities
        within 1e-5), ``fidelity_statevector`` against a numpy complex128
        evaluation of the same circuit, and the amplitude encoding's
        POST /rerank of 100 documents against its f64 value.  Returns the
        kernel launches of the statevector reranks."""
        torch = self.torch
        from qrag_tpu_torch.config import QragConfig
        from qrag_tpu_torch.engine import QragEngine
        from qrag_tpu_torch.ops.statevector import fidelity_statevector

        def engine(**quantum):
            cfg = {"embedding": {"provider": "hash", "dim": index.d}, "quantum": quantum}
            return QragEngine(config=QragConfig.from_dict(cfg), index=index, device=self.dev)

        def hits(out):
            return ([[h["index"] for h in r] for r in out["results"]],
                    np.asarray([[h["score"] for h in r] for r in out["results"]]))

        launches, rows = {}, []
        q = queries(64)
        for nq in (4, 10, 16):
            sv = engine(n_qubits=nq, use_analytic_fidelity=False)
            an = engine(n_qubits=nq)
            self._all_launches(reset=True)
            out_sv = sv.search_rerank(q, k=10, candidates=100)
            for key, v in self._all_launches().items():
                launches[("quantum", key)] = launches.get(("quantum", key), 0) + v
            out_an = an.search_rerank(q, k=10, candidates=100)
            (i_sv, s_sv), (i_an, s_an) = hits(out_sv), hits(out_an)
            if out_sv["reranker_used"] != "quantum":
                raise AssertionError(out_sv["reranker_used"])
            reorders = _same_ranking(i_sv, s_sv, i_an, s_an, 1e-5)
            err = float(np.abs(s_sv - s_an).max())
            ms = {}
            for name, eng in (("statevector", sv), ("analytic", an)):
                t = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    eng.search_rerank(q, k=10, candidates=100)
                    t.append(1e3 * (time.perf_counter() - t0))
                ms[name] = float(np.median(t))
            # the statevector against numpy complex128 on one query and 8 rows
            v = queries(9)
            got = fidelity_statevector(torch.from_numpy(v[0]).to(self.dev),
                                       torch.from_numpy(v[1:]).to(self.dev), nq).cpu().numpy()
            want = np.array([abs(np.vdot(_np_statevector(v[0], nq), _np_statevector(r, nq))) ** 2
                             for r in v[1:]])
            np_err = float(np.abs(got - want).max())
            if np_err > 1e-5:
                raise AssertionError(f"n_qubits={nq}: fidelity_statevector off numpy by {np_err}")
            rows.append((nq, ms["statevector"], ms["analytic"], err, np_err, reorders))
            if nq == 4:
                with self._serve(sv) as port:
                    served = _post(port, "/search_rerank", {"vectors": q[:4].tolist(), "k": 10,
                                                            "candidates": 100})
                if hits(served)[0] != i_sv[:4]:
                    raise AssertionError("served statevector /search_rerank differs")
        for nq, s_ms, a_ms, err, np_err, reorders in rows:
            print(f"(f) fused search_rerank B=64 k=10 C=100 [{self.card}] n_qubits={nq}: "
                  f"full statevector {s_ms:.3f} ms vs analytic {a_ms:.3f} ms (host clock, median "
                  f"of 3); same top-10 (reorders between fidelities within 1e-5 of each other: "
                  f"{reorders}), max |fidelity diff| {err:.2e}; fidelity_statevector vs numpy "
                  f"complex128 max err {np_err:.2e}", flush=True)
        print(f"(f) kernel launches of the statevector reranks: {launches}", flush=True)
        self.amplitude_rerank(index)
        return launches

    def amplitude_rerank(self, index):
        """POST /rerank with 100 documents under ``encoding="amplitude"``
        against the amplitude fidelity computed in f64."""
        from qrag_tpu_torch.config import QragConfig
        from qrag_tpu_torch.engine import QragEngine
        from qrag_tpu_torch.pipeline.embeddings import MockEmbedder

        cfg = {"embedding": {"provider": "hash", "dim": index.d},
               "quantum": {"encoding": "amplitude"}}
        eng = QragEngine(config=QragConfig.from_dict(cfg), index=index, device=self.dev)
        nq = eng.config.quantum.n_qubits
        query = "find the sponsor segment"
        contents = [f"segment {i}: " + ("sponsor read " if i % 4 else "the news ") * (1 + i % 7)
                    for i in range(100)]
        docs = [{"id": str(i), "content": c} for i, c in enumerate(contents)]
        with self._serve(eng) as port:
            t0 = time.perf_counter()
            resp = _post(port, "/rerank", {"query": query, "documents": docs, "top_k": 100,
                                           "reranker_type": "quantum"})
            ms = 1e3 * (time.perf_counter() - t0)
        e = np.asarray(MockEmbedder(dim=nq * 2)([query] + contents), np.float64)
        amp = np.zeros((e.shape[0], 2 ** nq))
        width = min(e.shape[1], 2 ** nq)
        amp[:, :width] = e[:, :width]
        amp /= np.linalg.norm(amp, axis=1, keepdims=True)
        fid = (amp[1:] @ amp[0]) ** 2
        got = {e_["document"]["id"]: e_["score"] for e_ in resp["documents"]}
        err = max(abs(got[str(i)] - fid[i]) for i in range(100))
        order = [e_["document"]["id"] for e_ in resp["documents"]]
        if resp["reranker_used"] != "quantum" or len(got) != 100 or err > 1e-5:
            raise AssertionError(f"amplitude /rerank: {resp['reranker_used']}, err {err}")
        if [fid[int(i)] for i in order] != sorted(fid, reverse=True):
            # an order that disagrees with f64 only inside f32 rounding
            gaps = np.diff([fid[int(i)] for i in order])
            if gaps.max() > 1e-6:
                raise AssertionError("amplitude /rerank order differs from f64")
        print(f"(f) POST /rerank 100 documents, encoding=amplitude n_qubits={nq} "
              f"[{self.card}]: scores within {err:.2e} of the f64 amplitude fidelity, "
              f"order equal; {ms:.2f} ms (one HTTP request)", flush=True)

    # ------------------------------------------------------------- phase 10

    def modes_sharded_path(self, n_rows=1_000_000):
        """Phase 10 over phase 5's 1,000,000 unit rows: (a) the approx /
        verified / refined modes, (d) the fused rerank over a quantized
        index (both the modes path: K7), (b) the sharded index on a 1 x 4
        mesh of slots on this card and (c) its elastic wrapper (the
        sharded path: K1 on every shard).  Returns the kernel launches of
        the two paths' runs."""
        t0 = time.perf_counter()
        self._free()
        rng = np.random.default_rng(0)
        x = rng.standard_normal((n_rows, 768), dtype=np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        self._aside = {}
        self._all_launches(reset=True)
        index, bounded_ms = self.modes_path(x)
        self.quantized_fused(x)
        launches = {("modes", key): v - self._aside.get(key, 0)
                    for key, v in self._all_launches().items()}
        aside = {("modes", key): v for key, v in self._aside.items() if v}
        self._aside = {}
        self._all_launches(reset=True)
        self.sharded_path(x, index, bounded_ms)
        del index
        self._free()
        self.elastic_path(x)
        launches.update({("sharded", key): v - self._aside.get(key, 0)
                         for key, v in self._all_launches().items()})
        aside.update({("sharded", key): v for key, v in self._aside.items() if v})
        print(f"phase 10 (selection modes, quantized fused rerank, sharded, elastic): "
              f"{time.perf_counter() - t0:.1f} s; launches {launches}; launches of the "
              f"comparison engines, booked aside {aside}", flush=True)
        return launches

    def _aside_call(self, fn):
        """``fn()``, a run of the engine a path is held against (the
        unsharded or unquantized one) inside the path's counting window:
        its kernel launches are booked aside, so that the path's counts
        hold the path's own calls only."""
        before = self._all_launches()
        out = fn()
        for key, n in self._all_launches().items():
            self._aside[key] = self._aside.get(key, 0) + n - before[key]
        return out

    def _mode_oracle(self, snap, unit):
        """(B, k, queries, oracle (qt, ov, oi), full goodness) for the two
        cells of phase 10: B=1024 k=10 and B=1 k=100."""
        from qrag_tpu_torch.ops.topk import _goodness

        cells = []
        for b, k in ((1024, 10), (1, 100)):
            q = unit(b)
            qt, ov, oi = self._oracle(snap, q, k)
            g = _goodness(qt, snap.matrix, "l2", snap.sqnorms, snap.valid)
            cells.append((b, k, q, (qt, ov, oi), g))
        return cells

    def _search_check(self, label, search, snap, cell, exact, recall_floor=0.99):
        """One search against the oracle: exact modes under the exactness
        contract, the others by recall@k (at least ``recall_floor``) and
        the error of the returned values against the oracle's value of
        the same rows.  Returns (recall, max value error, tie reorders)."""
        torch = self.torch
        b, k, q, (qt, ov, oi), g = cell
        res = search(q, k)
        idx = torch.from_numpy(res.indices).long().to(self.dev)
        dist = torch.from_numpy(res.scores).to(self.dev)
        err = float((dist + g.gather(1, idx)).abs().max())
        recall = _recall(res.indices, oi.cpu().numpy())
        ties = 0
        if exact:
            ties = _check_exact(idx, -dist, oi, ov, g, atol=1e-4)
        elif recall < recall_floor or err > 1e-4:
            raise AssertionError(f"{label} B={b} k={k}: recall@{k} {recall}, value error {err}")
        return res, recall, err, ties

    def _profile_calls(self, fn, calls, label):
        """A ``torch.profiler`` trace of ``calls`` calls of ``fn``: wall,
        device busy and idle share per call, the top device kernels
        (reported, never asserted; profiled wall times run above
        unprofiled ones)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / calls
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
        if not by_name:
            print(f"profile {label}: not measured (the profiler saw no device time)")
            return
        busy = sum(by_name.values()) / calls
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile [{self.card}]: {label}, {calls} calls: wall {wall:.3f} ms/call, "
              f"device busy {busy:.3f} ms/call, idle share {1 - busy / wall:.2f}; device "
              f"ms/call by kernel: {[(n[:50], round(ms / calls, 3)) for n, ms in top]}",
              flush=True)

    def modes_path(self, x):
        """(a) ``index.search`` in "approx", "verified" and "refined" (and
        "bounded" beside them) at B=1024 k=10 and B=1 k=100 against the
        f32 oracle: recall, value error, ``fallback_rows``, ms, K7's
        launches per call.  Returns the index (bounded, for (b)) and the
        bounded ms per cell."""
        torch = self.torch
        from qrag_tpu_torch.index.flat_index import DeviceFlatIndex
        from qrag_tpu_torch.ops import topk as tk
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.ops.cuda import scan_topk as ct

        t0 = time.perf_counter()
        index = DeviceFlatIndex.from_numpy(x, topk_mode="approx", device=self.dev)
        snap = index.device_buffers()
        index.search(x[:1], k=10)
        print(f"(a) selection modes [{self.card}]: {x.shape[0]:,} x 768 f32 unit rows "
              f"(phase 5's), capacity {snap.matrix.shape[0]}; setup "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cells = self._mode_oracle(snap, self._unit(10))
        bounded_ms = {}
        for mode in ("approx", "verified", "refined", "bounded"):
            index.topk_mode = mode
            for cell in cells:
                b, k = cell[0], cell[1]
                k7 = dict(ct.launches)
                k1 = sum(fused_scan.launches.values())
                routes = dict(tk.selection_routes)
                fb0 = index.fallback_rows
                _, recall, err, ties = self._search_check(
                    f"index.search {mode}", index.search, snap, cell,
                    exact=mode in ("verified", "bounded"),
                )
                per_call = {t: c - k7[t] for t, c in ct.launches.items()}
                k1_calls = sum(fused_scan.launches.values()) - k1
                rose = {r: c - routes[r] for r, c in tk.selection_routes.items()}
                fb = index.fallback_rows - fb0
                want_k7 = {"approx": ("float32", 1), "verified": ("float32", 1),
                           "refined": ("bfloat16", 1), "bounded": (None, 0)}[mode]
                if mode != "bounded" and (
                    per_call[want_k7[0]] != 1 or sum(per_call.values()) != 1
                    or rose != {"scan_topk": 1, "product_sort": 0}
                ):
                    raise AssertionError(f"{mode} B={b}: K7 launches {per_call}, routes {rose}")
                if mode == "bounded" and (sum(per_call.values()) or not k1_calls):
                    raise AssertionError(f"bounded B={b}: K7 {per_call}, K1 {k1_calls}")
                q = cell[2]
                ms = self._events_ms(lambda: index.search(q, k), 3 if b > 1 else 10)
                if mode == "bounded":
                    bounded_ms[(b, k)] = ms
                print(f"(a) index.search topk_mode={mode} B={b} k={k} [{self.card}]: "
                      f"recall@{k} {recall:.4f} vs the f32 oracle, max |value - oracle| "
                      f"{err:.3e}" + (f" (exact: identity equal but {ties} sub-noise tie "
                                      f"reorders)" if mode in ("verified", "bounded") else "")
                      + f"; fallback_rows +{fb}; {ms:.3f} ms (events, host included); "
                      f"K7 launches per call {per_call}, K1 launches {k1_calls}", flush=True)
                if b > 1 and mode in ("approx", "refined"):
                    self._profile_calls(lambda: index.search(q, k), 3,
                                        f"index.search {mode} B={b} k={k}")
        del cells
        self._free()
        return index, bounded_ms

    def quantized_fused(self, x):
        """(d) the repaired fused rerank over a quantized index: /search_rerank
        B=1 C=100 (quantum, classical, auto) equal to an unquantized
        engine's over the same bf16 store in the same ("approx") mode."""
        torch = self.torch
        from qrag_tpu_torch.config import QragConfig
        from qrag_tpu_torch.engine import QragEngine
        from qrag_tpu_torch.ops.cuda import scan_topk as ct
        from qrag_tpu_torch.ops.scan_topk import CAST_ROWS

        t0 = time.perf_counter()
        engines = {}
        for name, over in (("quantized", {"quantization": "int8", "dtype": "bfloat16"}),
                           ("unquantized", {"dtype": "bfloat16", "topk_mode": "approx"})):
            # the rows are unit already: no host normalization pass
            cfg = {"embedding": {"provider": "hash", "dim": 768},
                   "index": {**over, "normalize": False}}
            eng = QragEngine(config=QragConfig.from_dict(cfg), device=self.dev)
            eng.index.add(x)
            eng.index.device_buffers()
            engines[name] = eng
        qeng, ueng = engines["quantized"], engines["unquantized"]
        if not torch.equal(qeng.index.device_buffers().matrix, ueng.index.device_buffers().matrix):
            raise AssertionError("the two engines' stores differ")
        capacity = qeng.index.device_buffers().matrix.shape[0]
        blocks = -(-capacity // CAST_ROWS)
        unit = self._unit(11)
        texts = ["find the advertisement segment"]
        rows = []
        for rtype in ("quantum", "classical", "auto"):
            q = texts if rtype == "auto" else unit(1)
            k7 = sum(ct.launches.values())
            got = qeng.search_rerank(q, k=10, candidates=100, reranker_type=rtype)
            launched = sum(ct.launches.values()) - k7
            want = self._aside_call(
                lambda: ueng.search_rerank(q, k=10, candidates=100, reranker_type=rtype))
            gi = [[h["index"] for h in r] for r in got["results"]]
            wi = [[h["index"] for h in r] for r in want["results"]]
            gs = np.asarray([[h["score"] for h in r] for r in got["results"]])
            ws = np.asarray([[h["score"] for h in r] for r in want["results"]])
            if gi != wi or not np.array_equal(gs, ws) or got["reranker_used"] != want["reranker_used"]:
                raise AssertionError(f"quantized fused {rtype}: {gi} != {wi}")
            if launched != blocks:
                raise AssertionError(f"quantized fused {rtype}: K7 launched {launched} "
                                     f"times, {blocks} f32 blocks")
            ms = self._events_ms(
                lambda: qeng.search_rerank(q, k=10, candidates=100, reranker_type=rtype), 5)
            rows.append(f"{rtype} {ms:.3f} ms")
        modes = qeng.stats()["index"]["effective_topk_modes"]
        if modes["fused_candidates"] != "approx":
            raise AssertionError(f"effective modes {modes}")
        one, many = self._request_peak(qeng, unit)
        store_f32 = capacity * 768 * 4
        if one > store_f32 / 4:
            raise AssertionError(f"quantized fused: a request allocates {one} bytes, "
                                 f"the f32 store is {store_f32}")
        print(f"(d) quantized index (int8 row scan, bf16 store) /search_rerank B=1 k=10 "
              f"candidates=100 [{self.card}]: equal (indices, scores bit for bit) to the "
              f"unquantized bf16-store engine in 'approx'; K7 f32 once per f32 block "
              f"({blocks} blocks of {CAST_ROWS} rows a request); {'; '.join(rows)} "
              f"(events, engine call); device memory a request allocates beyond the "
              f"resident state: {one / 2**20:.1f} MiB alone, {many / 2**20:.1f} MiB at the "
              f"peak of 4 concurrent requests (an f32 copy of the store would be "
              f"{store_f32 / 2**20:.1f} MiB); effective modes {modes}; setup "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del engines, qeng, ueng
        self._free()

    def _request_peak(self, engine, unit):
        """Device memory that /search_rerank B=1 C=100 allocates beyond
        what is resident, for one request and at the peak of four
        concurrent ones (threads, as the HTTP server's handlers run)."""
        torch = self.torch
        q = [unit(1) for _ in range(4)]

        def call(i):
            engine.search_rerank(q[i], k=10, candidates=100, reranker_type="quantum")

        peaks = []
        for n in (1, 4):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
        return peaks

    def sharded_path(self, x, index, bounded_ms):
        """(b) the sharded index on a 1 x 4 mesh of slots on this card
        (bounded): identity and tie order against the oracle, allgather
        equal to ring, the summed counters, K1 on every shard; the
        sharded search_rerank against the unsharded engine; the sharded
        accelerator at B=1; /search and /search_rerank through
        ``create_server`` on a ``--sharded`` engine."""
        torch = self.torch
        from qrag_tpu_torch.config import MeshConfig, QragConfig
        from qrag_tpu_torch.engine import QragEngine
        from qrag_tpu_torch.ops.cuda import fused_scan
        from qrag_tpu_torch.parallel.mesh import make_mesh
        from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex
        from qrag_tpu_torch.serving import http_app

        t0 = time.perf_counter()
        mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=4), device=self.dev)
        sh = ShardedFlatIndex(x, mesh, topk_mode="bounded")
        sh.search(x[:1], k=10)
        lay = sh.layout()
        print(f"(b) sharded index [{self.card}]: 4 slots on {sorted({str(d) for d in mesh.devices.flat})}, "
              f"layout {lay}; setup {time.perf_counter() - t0:.1f} s — four shards on one "
              f"card measure the code, not a four-card scale-out", flush=True)
        snap = index.device_buffers()
        for cell in self._mode_oracle(snap, self._unit(12)):
            b, k, q = cell[0], cell[1], cell[2]
            results = {}
            for merge in ("allgather", "ring"):
                sh.merge = merge
                k1 = dict(fused_scan.launches)
                fb0, esc0 = sh.fallback_rows, sh.bounded_escalations
                res, recall, err, ties = self._search_check(
                    f"sharded {merge}", sh.search, snap, cell, exact=True)
                k1_calls = {key: c - k1[key] for key, c in fused_scan.launches.items() if c != k1[key]}
                if sum(k1_calls.values()) < 4:
                    raise AssertionError(f"sharded B={b}: K1 launched {k1_calls} (4 shards)")
                results[merge] = res
                ms = self._events_ms(lambda: sh.search(q, k), 3 if b > 1 else 10)
                print(f"(b) sharded search {merge} B={b} k={k}: identity equal to the f32 "
                      f"oracle (tie reorders {ties}), max |value - oracle| {err:.3e}; summed "
                      f"counters fallback_rows +{sh.fallback_rows - fb0} escalations "
                      f"+{sh.bounded_escalations - esc0}; K1 launches per call {k1_calls}; "
                      f"{ms:.3f} ms vs {bounded_ms[(b, k)]:.3f} unsharded bounded (events)",
                      flush=True)
                if merge == "allgather":
                    self._profile_calls(lambda: sh.search(q, k), 3,
                                        f"sharded search B={b} k={k}")
            a, r = results["allgather"], results["ring"]
            if not (np.array_equal(a.indices, r.indices) and np.array_equal(a.scores, r.scores)):
                raise AssertionError(f"allgather != ring at B={b}")
        sh.merge = "allgather"
        # the sharded rerank against the unsharded engine over the same rows
        cfg = QragConfig.from_dict({"embedding": {"provider": "hash", "dim": 768},
                                    "index": {"sharded": True},
                                    "mesh": {"data_parallel": 1, "model_parallel": 4}})
        seng = QragEngine(config=cfg, index=sh)
        index.topk_mode = "bounded"
        ueng = QragEngine(config=QragConfig.from_dict(
            {"embedding": {"provider": "hash", "dim": 768}}), index=index)
        unit = self._unit(13)
        for rtype in ("quantum", "classical", "auto"):
            q = ["find the advertisement segment"] if rtype == "auto" else unit(1)
            got = seng.search_rerank(q, k=10, candidates=100, reranker_type=rtype)
            want = self._aside_call(
                lambda: ueng.search_rerank(q, k=10, candidates=100, reranker_type=rtype))
            gi = [[h["index"] for h in r] for r in got["results"]]
            wi = [[h["index"] for h in r] for r in want["results"]]
            gs = [[h["score"] for h in r] for r in got["results"]]
            ws = [[h["score"] for h in r] for r in want["results"]]
            reorders = _same_ranking(gi, gs, wi, ws, 1e-5)
            if got["reranker_used"] != want["reranker_used"]:
                raise AssertionError(f"sharded rerank {rtype}: {got['reranker_used']}")
            ms = self._events_ms(
                lambda: seng.search_rerank(q, k=10, candidates=100, reranker_type=rtype), 3)
            ums = self._aside_call(lambda: self._events_ms(
                lambda: ueng.search_rerank(q, k=10, candidates=100, reranker_type=rtype), 3))
            print(f"(b) sharded search_rerank {rtype} B=1 k=10 candidates=100: equal to the "
                  f"unsharded engine's (fidelity from raw rows vs cached features: scores "
                  f"within 1e-5, reorders {reorders}); {ms:.3f} ms vs {ums:.3f} unsharded",
                  flush=True)
        # one /search and one /search_rerank through create_server on an
        # engine configured by the --sharded flag
        saved = {k: v for k, v in os.environ.items() if k.startswith("QRAG_")}
        try:
            os.environ["QRAG_MESH_MODEL_PARALLEL"] = "4"
            parser = http_app._parser()
            flags = http_app._configure(parser, parser.parse_args(["--sharded"]))
        finally:
            for key in [k for k in os.environ if k.startswith("QRAG_")]:
                del os.environ[key]
            os.environ.update(saved)
        if not (flags.index.sharded and flags.mesh.model_parallel == 4):
            raise AssertionError(f"--sharded config {flags.index} {flags.mesh}")
        flags = QragConfig.from_dict({**flags.to_dict(),
                                      "embedding": {"provider": "hash", "dim": 768}})
        served = QragEngine(config=flags, index=sh)
        q = unit(4)
        k1 = sum(fused_scan.launches.values())
        with self._serve(served) as port:
            s = _post(port, "/search", {"vectors": q.tolist(), "k": 10})
            rr = _post(port, "/search_rerank", {"vectors": q[:1].tolist(), "k": 10,
                                                "candidates": 100})
            stats = _get(port, "/stats")["index"]
        k1 = sum(fused_scan.launches.values()) - k1
        got = [[h["index"] for h in r] for r in s["results"]]
        if got != sh.search(q, k=10).indices.tolist() or stats["layout"]["mesh"]["model"] != 4:
            raise AssertionError(f"served sharded /search {got}; layout {stats.get('layout')}")
        want = self._aside_call(lambda: ueng.search_rerank(q[:1], k=10, candidates=100))
        _same_ranking([[h["index"] for h in r] for r in rr["results"]],
                      [[h["score"] for h in r] for r in rr["results"]],
                      [[h["index"] for h in r] for r in want["results"]],
                      [[h["score"] for h in r] for r in want["results"]], 1e-5)
        print(f"(b) create_server on a --sharded engine (QRAG_MESH_MODEL_PARALLEL=4): "
              f"/search B=4 equal to the index, /search_rerank B=1 equal to the unsharded "
              f"engine's; K1 launches {k1}; /stats layout {stats['layout']}, counters "
              f"fallback_rows={stats['verified_fallback_rows']} "
              f"escalations={stats['bounded_escalations']}", flush=True)
        del seng, ueng, served, index
        self._free()
        # the sharded accelerator at B=1 (uniform rows: nothing prunes,
        # every batch takes the ladder and stays exact)
        sh.small_batch_accel = "clustered"
        t1 = time.perf_counter()
        sh.build_clustered()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        from qrag_tpu_torch.ops.topk import _goodness

        q = self._unit(14)(1)
        qt, ov, oi = self._oracle(snap, q, 10)
        cell = (1, 10, q, (qt, ov, oi), _goodness(qt, snap.matrix, "l2", snap.sqnorms, snap.valid))
        fb0, esc0 = sh.cluster_fallbacks, sh.cluster_escalations
        _, recall, err, ties = self._search_check("sharded accelerator", sh.search, snap, cell,
                                                  exact=True)
        ms = self._events_ms(lambda: sh.search(cell[2], 10), 5)
        print(f"(b) sharded accelerator (clustered, per shard) B=1 k=10: build {build_s:.2f} s; "
              f"identity equal to the f32 oracle (tie reorders {ties}); escalations "
              f"+{sh.cluster_escalations - esc0}, fallbacks +{sh.cluster_fallbacks - fb0}; "
              f"{ms:.3f} ms", flush=True)
        del sh, snap
        self._free()

    def elastic_path(self, x):
        """(c) the elastic index on four slots of this card: a persistent
        failure injected on one slot re-shards over three with the same
        results and ``rebuilds == 1``."""
        from qrag_tpu_torch.parallel.elastic import ElasticShardedIndex, Slot

        t0 = time.perf_counter()
        slots = [Slot(i, self.dev) for i in range(4)]
        el = ElasticShardedIndex(x, devices=slots, topk_mode="bounded")
        q = self._unit(15)(64)
        before = el.search(q, k=10)
        el.inject_device_failure(slots[2])
        t1 = time.perf_counter()
        after = el.search(q, k=10)
        recover_s = time.perf_counter() - t1
        if not (np.array_equal(before.indices, after.indices)
                and np.allclose(before.scores, after.scores, rtol=1e-5, atol=1e-5)):
            raise AssertionError("elastic: results changed across the re-shard")
        if el.rebuilds != 1 or el.devices != [s for s in slots if s != slots[2]]:
            raise AssertionError(f"elastic: rebuilds {el.rebuilds}, slots {el.devices}")
        print(f"(c) elastic index [{self.card}]: 4 slots, persistent failure on slot 2: "
              f"evicted exactly it, re-sharded over 3 ({el.layout()}), B=64 k=10 equal "
              f"before and after; rebuilds {el.rebuilds}; recovery {recover_s:.2f} s; "
              f"setup {t1 - t0:.1f} s", flush=True)
        del el
        self._free()


    # ------------------------------------------------------------- phase 11

    def multiprocess_path(self):
        """Phase 11, several processes: (a) NCCL at world size 1 in this
        process (1 x 1 sharded index, one sharded train step, SP at
        mp = 1, each against its one-process counterpart); (b) + (e) two
        gloo ranks on this card over the default corpus (the cross-rank
        sharded search, then the elastic index losing rank 1); (c) + (d)
        two gloo ranks training at the shipped widths (dp 2 x mp 1, dp 1
        x mp 2) and scoring 4,096 tokens sequence-parallel.  Returns the
        kernel launches of the phase's path runs."""
        import tempfile

        from qrag_tpu_torch.index.flat_index import _host_sqnorms
        from qrag_tpu_torch.ops import bounded_topk as bt

        torch = self.torch
        t0 = time.perf_counter()
        self._free()
        self._aside = {}
        self._all_launches(reset=True)
        self.nccl_world_one()
        launches = {("multiprocess", key): v - self._aside.get(key, 0)
                    for key, v in self._all_launches().items()}
        with tempfile.TemporaryDirectory() as tmp:
            index_world = _spawn_world("index", 2, tmp, self.card)
            try:
                # the corpus, made once for the ranks while they start,
                # and the f32 oracle over it
                x = _unit_rows(1_000_000)
                np.save(os.path.join(tmp, "corpus.tmp.npy"), x)
                os.replace(os.path.join(tmp, "corpus.tmp.npy"), os.path.join(tmp, "corpus.npy"))
                xt = torch.from_numpy(x).to(self.dev)
                sq = torch.from_numpy(_host_sqnorms(x)).to(self.dev)
                oracle = {}
                for (b, k), q in _index_queries().items():
                    qt = torch.from_numpy(q).to(self.dev)
                    ov, oi = bt._exact_full_sort(qt, xt, sq, k, "l2", None)
                    oracle[(b, k)] = (qt, ov, oi)
            except BaseException:
                _kill_world(index_world)
                raise
            reports = _join_world(index_world, timeout=300)
            t_index = time.perf_counter() - t0
            self.check_index_world(reports, oracle, _PairGoodness(xt, sq))
            del xt, sq, oracle, x
            self._free()
            t1 = time.perf_counter()
            model_reports = _join_world(_spawn_world("model", 2, tmp, self.card), timeout=300)
            self.check_model_world(model_reports)
            t_model = time.perf_counter() - t1
        for rep in reports + model_reports:
            for key, n in _launches_from_json(rep["launches"]).items():
                launches[("multiprocess", key)] = launches.get(("multiprocess", key), 0) + n
        print(f"phase 11 (several processes) [{self.card}]: {time.perf_counter() - t0:.1f} s "
              f"(index world {t_index:.1f} s with the oracle, model world {t_model:.1f} s); "
              f"launches {launches}; launches of the comparison paths, booked aside "
              f"{ {k: v for k, v in self._aside.items() if v} } — two ranks on one card "
              f"measure the code, not a scale-out", flush=True)
        return launches

    def nccl_world_one(self):
        """(a) NCCL at world size 1: the 1 x 1 sharded index (its merge
        and counters through NCCL collectives of one rank) equal bit for
        bit to the unsharded index; one sharded train step equal to
        ``make_trainer``'s; SP at mp = 1 against the dense forward."""
        import dataclasses
        import tempfile

        torch = self.torch
        from qrag_tpu_torch.config import MeshConfig
        from qrag_tpu_torch.index.flat_index import DeviceFlatIndex
        from qrag_tpu_torch.models import cross_encoder as ce
        from qrag_tpu_torch.models.sequence_parallel import forward_sequence_parallel
        from qrag_tpu_torch.parallel import mesh as pmesh
        from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex
        from qrag_tpu_torch.parallel.train import make_sharded_trainer, make_trainer, synthetic_batch

        with tempfile.TemporaryDirectory() as tmp:
            pmesh.distributed_init(f"file://{tmp}/store", 1, 0, backend="nccl")
            grid = pmesh.make_mesh(MeshConfig(data_parallel=1, model_parallel=1))
            if not grid.spans_processes or torch.distributed.get_backend() != "nccl":
                raise AssertionError(f"world one: group {grid.group}")
            x = _unit_rows(262_144, seed=3)
            sh = ShardedFlatIndex(x, grid, topk_mode="bounded")
            un = DeviceFlatIndex.from_numpy(x, topk_mode="bounded", device=self.dev)
            unit = self._unit(18)
            for b, k in ((1024, 10), (1, 100)):
                q = unit(b)
                for merge in ("allgather", "ring"):
                    sh.merge = merge
                    got = sh.search(q, k)
                    want = self._aside_call(lambda: un.search(q, k))
                    if not (np.array_equal(got.indices, want.indices)
                            and np.array_equal(got.scores, want.scores)):
                        raise AssertionError(f"(a) 1 x 1 sharded {merge} B={b} != unsharded")
            print(f"(a) NCCL world of one [{self.card}]: 1 x 1 sharded index over {x.shape[0]:,} x 768 "
                  f"(bounded, both merges, B=1024 k=10 and B=1 k=100) equal bit for bit to the "
                  f"unsharded index; counters fallback_rows={sh.fallback_rows} "
                  f"escalations={sh.bounded_escalations} (unsharded {un.fallback_rows}, "
                  f"{un.bounded_escalations})", flush=True)
            del sh, un
            self._free()
            cfg = ce._load_scorer_config("artifacts/cross_encoder")
            batch = synthetic_batch(np.random.RandomState(0), 64, cfg.max_len)
            # the embedding gathers' backward accumulates in a run-to-run
            # order unless deterministic algorithms are asked for
            torch.use_deterministic_algorithms(True, warn_only=True)
            one, _, one_step = make_trainer(cfg, device=self.dev)
            shd, _, shd_step = make_sharded_trainer(cfg, grid)
            l1, l2 = one_step(*batch), shd_step(*batch)
            torch.use_deterministic_algorithms(False)
            diff = max(float((a - b).detach().abs().max())
                       for a, b in zip(one.parameters(), shd.parameters()))
            if not torch.equal(l1, l2) or diff != 0.0:
                raise AssertionError(f"(a) sharded step: loss {float(l1)} vs {float(l2)}, "
                                     f"parameters differ by {diff}")
            sp_cfg = dataclasses.replace(cfg, head_type="cls")
            net = ce.load_module(ce.CrossEncoder(sp_cfg), ce.init_params(sp_cfg, seed=0))
            net = net.to(self.dev).eval()
            toks, mask = ce.tokenize_batch("advert", ["sponsor deal " * 30] * 8, sp_cfg.max_len)
            with torch.inference_mode():
                sp = forward_sequence_parallel(net, toks, mask, sp_cfg, grid)
                dense = net(torch.from_numpy(toks).to(self.dev).long(),
                            torch.from_numpy(mask).to(self.dev), ce.default_dtype(self.dev))
            sp_err = float((sp - dense).abs().max())
            # the CLS row's layer norm runs on a (B, d) slice, not (B, T, d)
            if sp_err > 1e-5:
                raise AssertionError(f"(a) SP at mp = 1 differs from the dense forward by {sp_err}")
            print(f"(a) sharded train step (shipped widths, 64 pairs, bf16) equal bit for bit to "
                  f"make_trainer's (loss {float(l1):.6f}); SP at mp = 1 (cls head, B=8 T=224) "
                  f"within {sp_err:.2e} of the dense forward", flush=True)
            del one, shd, net
            pmesh.shutdown()
            self._free()

    def check_index_world(self, reports, oracle, pair_g):
        """(b) and (e) from the ranks' reports: identity and tie order
        against the f32 oracle on both ranks, allgather equal to ring,
        the counters the same sum on both ranks, K1 on every rank's shard;
        the survivor's eviction and exact answers after it."""
        torch = self.torch
        for rep in reports:
            for line in rep["lines"]:
                print(f"rank {rep['rank']}: {line}", flush=True)
        res = [dict(np.load(rep["npz"])) for rep in reports]
        for (b, k), (qt, ov, oi) in oracle.items():
            if b == 64:  # the elastic cell, below
                continue
            for r, got in enumerate(res):
                for merge in ("allgather", "ring"):
                    idx = torch.from_numpy(got[f"{merge}_{b}_idx"]).long().to(self.dev)
                    dist = torch.from_numpy(got[f"{merge}_{b}_val"]).to(self.dev)
                    ties = _check_exact(idx, -dist, oi, ov, pair_g.of(qt), atol=1e-4)
                    err = float((dist + pair_g.of(qt)[_rows_of(idx), idx]).abs().max())
                    print(f"(b) rank {r} {merge} B={b} k={k}: identity equal to the f32 oracle "
                          f"(tie reorders {ties}), max |value - oracle| {err:.3e}", flush=True)
                for key in ("idx", "val"):
                    if not np.array_equal(got[f"allgather_{b}_{key}"], got[f"ring_{b}_{key}"]):
                        raise AssertionError(f"(b) rank {r} B={b}: allgather != ring")
                    if not np.array_equal(got[f"allgather_{b}_{key}"], res[0][f"allgather_{b}_{key}"]):
                        raise AssertionError(f"(b) B={b}: ranks differ")
        counters = [rep["counters"] for rep in reports]
        if counters[0] != counters[1]:
            raise AssertionError(f"(b) counters differ between ranks: {counters}")
        for rep in reports:
            if min(rep["k1_per_search"]) < 1:
                raise AssertionError(f"(b) rank {rep['rank']}: K1 per search {rep['k1_per_search']}")
        qt, ov, oi = oracle[(64, 10)]
        for name, got in (("rank 0 before", res[0]["elastic_before"]),
                          ("rank 1 before", res[1]["elastic_before"]),
                          ("survivor after", res[0]["elastic_after"])):
            if not np.array_equal(got, oi.cpu().numpy()):
                idx = torch.from_numpy(got).long().to(self.dev)
                g = pair_g.of(qt)
                _check_exact(idx, g[_rows_of(idx), idx], oi, ov, g, atol=1e-4)
        rep0 = reports[0]
        print(f"(e) elastic over two ranks [{self.card}]: rank 1 left (os._exit); rank 0's group "
              f"probe {rep0['probe']}, localized {rep0['bad']} (rank 1's slots only), re-sharded "
              f"over {rep0['survivors']}; B=64 k=10 equal to the f32 oracle before (both ranks) "
              f"and after; recovery {rep0['recovery_s']:.2f} s (probe {rep0['probe_s']:.2f}, "
              f"localize {rep0['localize_s']:.2f}, re-shard + search {rep0['reshard_s']:.2f})",
              flush=True)

    def check_model_world(self, reports):
        """(c) and (d) from the ranks' reports: every sharded loss within
        ``BF16_STEP_LOSS_RTOL`` of ``make_trainer``'s on the same batches
        (whose bf16 step is itself held to the bounds by
        ``bf16_step_deviation``), the same losses on both ranks, the
        first step's gradients within ``TRAIN_GRAD_RTOL`` and the
        parameters after five steps within ``TRAIN_PARAM_RTOL`` of
        ``make_trainer``'s; SP logits within ``SP_LOGIT_ATOL`` of the
        dense forward."""
        from qrag_tpu_torch.models import cross_encoder as ce

        ref = reports[0]["reference"]
        rel, cos = ref["bf16_deviation"]
        if rel > ce.BF16_STEP_LOSS_RTOL or cos < ce.BF16_GRAD_COSINE_FLOOR:
            raise AssertionError(f"(c) make_trainer's bf16 step off its bounds: {rel}, {cos}")
        arrays = dict(np.load(reports[0]["npz"]))
        cfg = ce._load_scorer_config("artifacts/cross_encoder")
        start = ce.init_params(cfg, 0)

        def keyless(name, a):
            return np.delete(a, np.s_[cfg.dim:2 * cfg.dim]) if name.endswith("attn.qkv.b") else a

        ref_g, ref_p = ({k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}
                        for pre in ("ref.grad.", "ref.param."))
        for layout in ("dp2_mp1", "dp1_mp2"):
            losses = [rep[layout]["losses"] for rep in reports]
            if losses[0] != losses[1]:
                raise AssertionError(f"(c) {layout}: ranks report {losses}")
            dev = max(abs(a - b) / abs(b) for a, b in zip(losses[0], ref["losses"]))
            if dev > ce.BF16_STEP_LOSS_RTOL or not np.isfinite(losses[0]).all():
                raise AssertionError(f"(c) {layout}: losses {losses[0]} vs {ref['losses']}")
            # Adam's step does not see a gradient's scale, so the losses
            # alone would pass a gradient counted once per model rank: the
            # first step's gradients, leaf by leaf, against make_trainer's;
            # the parameters after 5 steps, each leaf's distance from
            # make_trainer's over the distance make_trainer moved it (the
            # key bias left out: its gradient is zero in exact arithmetic,
            # so Adam walks it along rounding noise)
            grad_err, grad_leaf = max(
                (float(np.linalg.norm(arrays[f"{layout}.grad.{n}"] - g)
                       / max(float(np.linalg.norm(g)), 1e-30)), n) for n, g in ref_g.items())
            param_err, param_leaf = max(
                (float(np.linalg.norm(keyless(n, arrays[f"{layout}.param.{n}"] - p))
                       / max(float(np.linalg.norm(keyless(n, p - start[n]))), 1e-30)), n)
                for n, p in ref_p.items())
            param_abs = max(float(np.abs(arrays[f"{layout}.param.{n}"] - p).max())
                            for n, p in ref_p.items())
            if not grad_err <= TRAIN_GRAD_RTOL or not param_err <= TRAIN_PARAM_RTOL:
                raise AssertionError(f"(c) {layout}: first-step gradient off make_trainer's by "
                                     f"{grad_err} ({grad_leaf}; bound {TRAIN_GRAD_RTOL}), "
                                     f"parameters after 5 steps by {param_err} of their path "
                                     f"({param_leaf}; bound {TRAIN_PARAM_RTOL})")
            print(f"(c) sharded trainer {layout} [{self.card}]: 5 steps of 256 pairs x 224 tokens "
                  f"(bf16) losses {[round(v, 5) for v in losses[0]]}, make_trainer's "
                  f"{[round(v, 5) for v in ref['losses']]} (max rel {dev:.2e}, bound "
                  f"{ce.BF16_STEP_LOSS_RTOL}); first-step gradient, worst leaf |g - g_ref| / "
                  f"|g_ref| {grad_err:.3e} ({grad_leaf}; bound {TRAIN_GRAD_RTOL}); parameters "
                  f"after 5 steps, worst leaf |p - p_ref| / |p_ref - p_0| {param_err:.3e} "
                  f"({param_leaf}; bound {TRAIN_PARAM_RTOL}), max |p - p_ref| {param_abs:.3e}; "
                  f"ms a step (median of steps 2-5) "
                  f"{[rep[layout]['ms'] for rep in reports]} vs {ref['ms']:.3f} on one device; "
                  f"peak MiB per rank {[rep[layout]['peak_mib'] for rep in reports]} vs "
                  f"{ref['peak_mib']:.1f}", flush=True)
        sp = [rep["sp"] for rep in reports]
        if sp[0]["logits"] != sp[1]["logits"]:
            raise AssertionError("(d) SP logits differ between ranks")
        dense = np.asarray(reports[0]["dense"]["logits"])
        got = np.asarray(sp[0]["logits"])
        logit_err = float(np.abs(got - dense).max())
        # both forwards run the same operations at the same precision
        if not logit_err <= SP_LOGIT_ATOL:
            raise AssertionError(f"(d) SP logits off the dense forward's by {logit_err} "
                                 f"(bound {SP_LOGIT_ATOL})")
        print(f"(d) SP cls head, shipped widths, max_len 4096, B=8 T=4096, mp=2 [{self.card}]: "
              f"logits within {logit_err:.2e} of the dense forward (bound {SP_LOGIT_ATOL}); "
              f"ms {[s['ms'] for s in sp]} per rank vs "
              f"{reports[0]['dense']['ms']:.3f} dense on one; peak MiB {[s['peak_mib'] for s in sp]}"
              f" vs {reports[0]['dense']['peak_mib']:.1f}; gloo all_gather on CUDA tensors: "
              f"{reports[0]['gloo_cuda_all_gather']}", flush=True)

# Phase 11 (c): how far the sharded trainer (bf16, dp 2 x mp 1 and dp 1 x
# mp 2) may sit from make_trainer on the same batches.  The first step's
# gradient, per leaf, relative to make_trainer's (a gradient summed once
# too often is off by 1 or more); the parameters after five AdamW steps,
# per leaf, relative to how far make_trainer moved them from the seed's.
# Readings on an H100 (two runs, the same to the digit): gradients
# 2.10e-3 at dp 2 and 1.86e-3 at mp 2, parameters 5.95e-3 and 3.21e-2
# (pos_emb); the bounds leave about 5x and 3x the worst.
TRAIN_GRAD_RTOL = 1e-2
TRAIN_PARAM_RTOL = 0.1
# Phase 11 (d): SP's logits against the dense forward at the same
# precision.
SP_LOGIT_ATOL = 1e-3


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


def _model_flops(cfg, tokens, passes):
    """Multiply-add FLOPs of one sequence of ``tokens`` through a tower
    of ``cfg``: the qkv and out projections, ``passes`` attention passes
    (scores and att @ v; the interaction head runs two, each with its
    own out projection), the router and every expert (dense dispatch)
    or the dense FFN."""
    d, t = cfg.dim, tokens
    hidden = d * cfg.mlp_ratio
    per_token = 2 * d * 3 * d + passes * (4 * t * d + 2 * d * d)
    if cfg.n_experts > 0:
        per_token += 2 * d * cfg.n_experts + cfg.n_experts * 4 * d * hidden
    else:
        per_token += 4 * d * hidden
    return per_token * t * cfg.n_layers


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


def _float_twin(planes):
    """The plain twin of the float arm for ``planes``: (q, x, lane_rank,
    row_add, col_add, alpha) -> tuple of planes."""
    from qrag_tpu_torch.ops import bounded_topk as bt
    from qrag_tpu_torch.ops import window_scan as ws

    if planes == 1:
        return lambda *a: (ws.packed_window_scan(*a),)
    return bt.packed_window_scan_top3 if planes == 3 else bt.packed_window_scan_top2


@contextlib.contextmanager
def _twin_planes():
    """Route every packed window scan to the plain twins on the card,
    so a search can be repeated on the twin's planes."""
    import torch

    from qrag_tpu_torch.ops import bounded_topk as bt
    from qrag_tpu_torch.ops import window_scan as ws
    from qrag_tpu_torch.ops.cuda import fused_scan

    def twin(q, x, lane_rank, row_add=None, col_add=None, alpha=1.0, planes=2):
        lr = ws.make_lane_rank(x.shape[0], x.device)
        if x.dtype == torch.int8 and planes == 2:
            return bt.packed_window_scan_top2_int(q, x, lr)
        return _float_twin(planes)(q, x, lr, row_add, col_add, alpha)

    kernel = fused_scan.packed_window_scan
    fused_scan.packed_window_scan = twin
    try:
        yield
    finally:
        fused_scan.packed_window_scan = kernel


def _recall(got, truth):
    return float(np.mean([
        len(set(g.tolist()) & set(t.tolist())) / truth.shape[1]
        for g, t in zip(got, truth)
    ]))


def _same_ranking(idx, score, ref_idx, ref_score, tol):
    """Two top-k rankings (lists of index rows, score arrays) agree: the
    scores rank for rank within ``tol``, and the identities equal except
    where entries whose scores lie within ``tol`` of each other swap
    places (or swap across the k-th place).  Returns those reorders."""
    if float(np.abs(np.asarray(score) - np.asarray(ref_score)).max()) > tol:
        raise AssertionError(f"scores differ by more than {tol}")
    reorders = 0
    for row, (got, want) in enumerate(zip(idx, ref_idx)):
        ref = dict(zip(want, ref_score[row]))
        for p, i in enumerate(got):
            if i == want[p]:
                continue
            reorders += 1
            # the same row at another place within tol, or a row past
            # the k-th place whose score ties the boundary within tol
            near = ref[i] if i in ref else ref_score[row][-1]
            if abs(score[row][p] - near) > tol:
                raise AssertionError(f"row {row} place {p}: {i} is no tie of {want[p]}")
    return reorders


def _np_statevector(vector, n_qubits):
    """The reference encoding circuit in numpy complex128, written apart
    from the port: per qubit rz(v_i pi/2) ry(v_i pi) |0> as 2x2 matrices,
    their tensor product (qubit n-1 the most significant index bit),
    then cx(i, i+1) as index permutations."""
    v = np.asarray(vector, np.float64)
    norm = np.linalg.norm(v)
    if norm > 0:
        v = v / norm
    state = np.ones(1, complex)
    for i in range(n_qubits - 1, -1, -1):
        t = v[i] * np.pi if i < len(v) else 0.0
        ry = np.array([[np.cos(t / 2), -np.sin(t / 2)], [np.sin(t / 2), np.cos(t / 2)]], complex)
        rz = np.diag([np.exp(-0.5j * (t / 2)), np.exp(0.5j * (t / 2))])
        state = np.kron(state, rz @ ry @ np.array([1.0, 0.0], complex))
    idx = np.arange(2 ** n_qubits)
    for c in range(n_qubits - 1):
        state = state[idx ^ (((idx >> c) & 1) << (c + 1))]
    return state


# one f32 ulp of slack, as tests/test_int8_domain.py allows
_ULP_RTOL = 4e-7


def _own_oracle(q8, t, x8, scales, isq, k, metric, valid):
    """Numpy own-domain top-k (tests/test_int8_domain.py ``_oracle``):
    the exact int dots of the op's own rounded query, scaled in f32."""
    q8 = q8.cpu().numpy().astype(np.int64)
    t = t.cpu().numpy().astype(np.float32)
    x8 = x8.cpu().numpy().astype(np.int64)
    scale_rows = np.repeat(scales.cpu().numpy().astype(np.float32), WINDOW)
    isq = isq.cpu().numpy()
    s = (t[:, None] * scale_rows[None, :]).astype(np.float32) * (q8 @ x8.T).astype(np.float32)
    if metric == "l2":
        qsq = (t * t) * np.sum(q8 * q8, axis=1).astype(np.float32)
        xsq = (scale_rows * scale_rows) * isq.astype(np.float32)
        g = (np.float32(2.0) * s - qsq[:, None]) - xsq[None, :]
    else:
        g = s
    g = g.astype(np.float32)
    if valid is not None:
        g = np.where(valid[None, :], g, -np.inf)
    order = np.argsort(-g, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(g, order, axis=1), order, g


def _check_own(idx, vals, oi, ov, g=None):
    """Own-domain exactness: values to one f32 ulp, identity equal
    except at ties within that ulp."""
    idx, oi = np.asarray(idx), np.asarray(oi)
    np.testing.assert_allclose(vals, ov, rtol=_ULP_RTOL, atol=0)
    if g is not None and not np.array_equal(idx, oi):
        rows, pos = np.where(idx != oi)
        gap = np.abs(g[rows, idx[rows, pos]] - ov[rows, pos])
        if not (gap <= _ULP_RTOL * (1.0 + np.abs(ov[rows, pos]))).all():
            raise AssertionError(f"own-domain index mismatch at rows {rows.tolist()}")
    elif g is None and not np.array_equal(idx, oi):
        raise AssertionError("own-domain indices differ from full_topk_int8_domain")


# ------------------------------------------------------------ phase 11 ranks


def _unit_rows(n, seed=0, d=768):
    """``n`` unit rows of ``default_rng(seed)`` (phase 5's corpus at
    seed 0), made alike in every process."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _index_queries():
    """{(B, k): unit queries} of phase 11 (b) and (e), alike in every
    process."""
    rng = np.random.default_rng(16)
    out = {}
    for b, k in ((1024, 10), (1, 100), (64, 10)):
        q = rng.standard_normal((b, 768), dtype=np.float32)
        out[(b, k)] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return out


def _rows_of(idx):
    import torch

    return torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(idx)


class _PairGoodness:
    """The f32 l2 goodness of (query, row) pairs on demand (``_goodness``'s
    formula), so that no (B, N) matrix is held: ``of(q)[rows, cols]``."""

    def __init__(self, xt, sq):
        self.xt, self.sq = xt, sq

    def of(self, qt):
        xt, sq = self.xt, self.sq

        class _G:
            def __getitem__(self, key):
                rows, cols = key
                q = qt[rows]
                return 2.0 * (q * xt[cols]).sum(-1) - (q * q).sum(-1) - sq[cols]

        return _G()


def _launches_to_json(launches):
    return {":".join(map(str, key if isinstance(key, tuple) else (key,))): n
            for key, n in launches.items()}


def _launches_from_json(launches):
    out = {}
    for key, n in launches.items():
        parts = key.split(":")
        if parts[0] == "gather_rows":
            out["gather_rows"] = n
        elif parts[0] == "scan_topk":
            out[("scan_topk", parts[1])] = n
        else:
            out[(parts[0], int(parts[1]))] = n
    return out


def _spawn_world(kind, world, tmp, card):
    """``world`` ranks of this script (``--worker kind``), each with its
    output in ``tmp``; they join a gloo group through a file store."""
    procs = []
    for r in range(world):
        log = open(os.path.join(tmp, f"{kind}{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", kind, str(r), str(world),
             tmp, card], stdout=log, stderr=subprocess.STDOUT), log))
    return kind, tmp, procs


def _kill_world(spawned):
    for p, log in spawned[2]:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def _join_world(spawned, timeout):
    """Wait for every rank within ``timeout`` s (kill them all past it);
    a rank that exits nonzero fails the phase.  Returns the ranks'
    reports."""
    kind, tmp, procs = spawned
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        _kill_world(spawned)
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"{kind}{r}.log")) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"phase 11 {kind} rank {r} exited {p.returncode}:\n{tail}")
    reports = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f"{kind}{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def _write_report(tmp, kind, rank, report, arrays=None):
    if arrays is not None:
        report["npz"] = os.path.join(tmp, f"{kind}{rank}.npz")
        np.savez(report["npz"], **arrays)
    with open(os.path.join(tmp, f"{kind}{rank}.json"), "w") as f:
        json.dump(report, f)


def _worker(kind, rank, world, tmp, card):
    """One rank of phase 11: joins the gloo group of its world on this
    card and runs its part; its report goes to ``tmp``."""
    import torch

    from qrag_tpu_torch.parallel import mesh as pmesh

    rank, world = int(rank), int(world)
    pmesh.distributed_init(f"file://{tmp}/{kind}.store", world, rank, backend="gloo")
    smoke = Smoke(torch, device=str(pmesh.local_device()), card=card)
    smoke._all_launches(reset=True)
    report = {"rank": rank, "lines": []}
    # the index world leaves with os._exit (its group loses a peer)
    (_index_rank if kind == "index" else _model_rank)(smoke, rank, tmp, report)
    pmesh.shutdown()
    return 0


def _index_rank(smoke, rank, tmp, report):
    """(b) the default corpus (written by the script's process) sharded
    over the two ranks (bounded, f32 store) inside an elastic index:
    B=1024 k=10 and B=1 k=100 in both merges, timed; then (e) rank 1
    leaves, rank 0 probes, localizes, re-shards and answers."""
    torch = smoke.torch
    from qrag_tpu_torch.ops.cuda import fused_scan
    from qrag_tpu_torch.parallel.elastic import ElasticShardedIndex

    path = os.path.join(tmp, "corpus.npy")
    deadline = time.monotonic() + 120
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no corpus at {path}")
        time.sleep(0.1)
    t0 = time.perf_counter()
    x = np.load(path)
    el = ElasticShardedIndex(x, probe_timeout_s=20.0, topk_mode="bounded")
    sh = el.index
    if not (sh.mesh.spans_processes and sh.mesh.shape == {"data": 1, "model": 2}):
        raise AssertionError(f"(b) mesh {sh.mesh}")
    sh.search(x[:1], k=10)
    torch.cuda.synchronize()
    report["lines"].append(
        f"(b) {x.shape[0]:,} x 768 over a 1 x 2 mesh of ranks on {smoke.dev} (gloo), "
        f"{sh.layout()['rows_per_shard']:,} rows a shard (capacity with headroom); setup "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    arrays, k1s, report["ms"] = {}, [], {}
    queries = _index_queries()
    for (b, k), q in queries.items():
        if b == 64:
            continue
        for merge in ("allgather", "ring"):
            sh.merge = merge
            k1 = sum(fused_scan.launches.values())
            fb0, esc0 = sh.fallback_rows, sh.bounded_escalations
            res = sh.search(q, k)
            k1s.append(sum(fused_scan.launches.values()) - k1)
            arrays[f"{merge}_{b}_idx"], arrays[f"{merge}_{b}_val"] = res.indices, res.scores
            ms = smoke._events_ms(lambda: sh.search(q, k), 3 if b > 1 else 10)
            report["ms"][f"{merge}_{b}"] = ms
            report["lines"].append(
                f"(b) {merge} B={b} k={k}: {ms:.3f} ms a search (events); K1 launches "
                f"{k1s[-1]} on this rank; counters summed over the ranks +{sh.fallback_rows - fb0} "
                f"fallbacks, +{sh.bounded_escalations - esc0} escalations")
    report["counters"] = [sh.fallback_rows, sh.bounded_escalations]
    report["k1_per_search"] = k1s
    sh.merge = "allgather"
    del sh
    q64 = queries[(64, 10)]
    arrays["elastic_before"] = el.search(q64, k=10).indices
    report["launches"] = _launches_to_json(smoke._all_launches())
    if rank == 1:
        _write_report(tmp, "index", rank, report, arrays)
        os._exit(0)  # leave without shutting the group down
    time.sleep(1.5)
    t1 = time.perf_counter()
    healthy = el.probe()
    t2 = time.perf_counter()
    bad = el.localize_failures()
    t3 = time.perf_counter()
    if healthy or [(s.id, s.rank) for s in bad] != [(1, 1)]:
        raise AssertionError(f"(e) probe {healthy}, localized {bad}")
    el.remove_devices(bad)
    arrays["elastic_after"] = el.search(q64, k=10).indices
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    if el.rebuilds != 1 or el.mesh.spans_processes or el.index.ntotal != x.shape[0]:
        raise AssertionError(f"(e) after the eviction: {el.layout()}")
    report.update(probe=healthy, bad=[list(s[:1]) + [str(s.device), s.rank] for s in bad],
                  survivors=[[s.id, str(s.device), s.rank] for s in el.devices],
                  recovery_s=t4 - t1, probe_s=t2 - t1, localize_s=t3 - t2, reshard_s=t4 - t3,
                  launches=_launches_to_json(smoke._all_launches()))
    _write_report(tmp, "index", rank, report, arrays)
    os._exit(0)  # the group lost a peer: no teardown


def _long_batch(cfg, b=8):
    """B byte sequences of ``cfg.max_len`` tokens behind a CLS, row i
    padded over its last 300 i tokens."""
    from qrag_tpu_torch.models import cross_encoder as ce

    rng = np.random.default_rng(5)
    t = cfg.max_len
    toks = rng.integers(0, 256, (b, t)).astype(np.int32)
    toks[:, 0] = ce.CLS_ID
    mask = np.ones((b, t), np.float32)
    for i in range(b):
        if i:
            toks[i, t - 300 * i:] = ce.PAD_ID
            mask[i, t - 300 * i:] = 0.0
    return toks, mask


def _model_rank(smoke, rank, tmp, report):
    """(c) the sharded trainer at the shipped widths, dp 2 x mp 1 and
    dp 1 x mp 2, five steps of 256 synthetic pairs each, with
    ``make_trainer``'s run on rank 0 beside it; (d) SP at 4,096 tokens,
    mp = 2, with the dense forward on rank 0 beside it."""
    import dataclasses
    import statistics

    torch = smoke.torch
    import torch.distributed as dist

    from qrag_tpu_torch.config import MeshConfig
    from qrag_tpu_torch.models import cross_encoder as ce
    from qrag_tpu_torch.models.sequence_parallel import forward_sequence_parallel
    from qrag_tpu_torch.models.weights import param_paths
    from qrag_tpu_torch.parallel import mesh as pmesh
    from qrag_tpu_torch.parallel import train
    from qrag_tpu_torch.parallel.train import make_sharded_trainer, make_trainer, synthetic_batch

    cfg = ce._load_scorer_config("artifacts/cross_encoder")
    rng = np.random.RandomState(0)
    batches = [synthetic_batch(rng, 256, cfg.max_len) for _ in range(5)]
    names = param_paths(cfg)
    arrays = {}

    def whole(model, leaves):
        """{name: full array} of a trainer's leaves (blocks gathered over
        "model" for a sharded one: every rank calls it)."""
        if hasattr(model, "model_axis"):
            return train._gathered(model, cfg, leaves)
        return {m: t.detach().cpu().numpy() for m, t in leaves.items()}

    def run(step, model, tag):
        """Five steps; the first step's gradients and the parameters
        after the last, whole (gathered over "model": every rank calls
        it), into ``arrays`` under ``tag`` on rank 0."""
        losses, ms = [], []
        for n, b in enumerate(batches):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss = step(*b)
            e1.record()
            torch.cuda.synchronize()
            losses.append(float(loss))
            ms.append(e0.elapsed_time(e1))
            if n == 0:
                grads = whole(model, {m: model.get_parameter(m).grad for m in names})
        params = whole(model, {m: model.get_parameter(m) for m in names})
        if rank == 0:
            arrays.update({f"{tag}.grad.{m}": g for m, g in grads.items()})
            arrays.update({f"{tag}.param.{m}": p for m, p in params.items()})
        return losses, round(statistics.median(ms[1:]), 3)

    def peak_mib():
        torch.cuda.synchronize()
        return round(torch.cuda.max_memory_allocated() / 2**20, 1)

    for dp, mp in ((2, 1), (1, 2)):
        smoke._free()
        torch.cuda.reset_peak_memory_stats()
        grid = pmesh.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
        model, _, step = make_sharded_trainer(cfg, grid)
        losses, ms = run(step, model, f"dp{dp}_mp{mp}")
        report[f"dp{dp}_mp{mp}"] = {"losses": losses, "ms": ms, "peak_mib": peak_mib()}
        del model, step
    if rank == 0:
        smoke._free()
        torch.cuda.reset_peak_memory_stats()
        model, _, step = make_trainer(cfg, device=smoke.dev)
        losses, ms = run(step, model, "ref")
        ref = {"losses": losses, "ms": ms, "peak_mib": peak_mib()}
        del model, step

        def build():
            return ce.trainable(ce.load_module(ce.CrossEncoder(cfg), ce.init_params(cfg, 0)),
                                smoke.dev)

        def loss_of(model, dtype):
            return ce.bce_loss(model, *ce.device_batch(smoke.dev, *batches[0]), dtype)

        ref["bf16_deviation"] = ce.bf16_step_deviation(build, loss_of)
        report["reference"] = ref
    smoke._free()
    sp_cfg = dataclasses.replace(cfg, head_type="cls", max_len=4096)
    net = ce.load_module(ce.CrossEncoder(sp_cfg), ce.init_params(sp_cfg, seed=0))
    net = net.to(smoke.dev).eval()
    toks, mask = _long_batch(sp_cfg)
    grid = pmesh.make_mesh(MeshConfig(data_parallel=1, model_parallel=2))
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        logits = forward_sequence_parallel(net, toks, mask, sp_cfg, grid)
        ms = smoke._events_ms(lambda: forward_sequence_parallel(net, toks, mask, sp_cfg, grid), 3)
        report["sp"] = {"logits": logits.cpu().tolist(), "ms": round(ms, 3),
                        "peak_mib": peak_mib()}
        if rank == 0:
            smoke._free()
            torch.cuda.reset_peak_memory_stats()
            tt = torch.from_numpy(toks).to(smoke.dev).long()
            mt = torch.from_numpy(mask).to(smoke.dev)
            dense = net(tt, mt, ce.default_dtype(smoke.dev))
            ms = smoke._events_ms(lambda: net(tt, mt, ce.default_dtype(smoke.dev)), 3)
            report["dense"] = {"logits": dense.cpu().tolist(), "ms": round(ms, 3),
                               "peak_mib": peak_mib()}
    # whether gloo gathers device tensors (collectives.py stages them
    # through the host either way)
    t = torch.ones(4, device=smoke.dev)
    try:
        dist.all_gather([torch.empty_like(t) for _ in range(2)], t)
        report["gloo_cuda_all_gather"] = "accepted"
    except (RuntimeError, ValueError) as e:
        report["gloo_cuda_all_gather"] = f"refused ({str(e).splitlines()[0][:120]})"
    report["launches"] = _launches_to_json(smoke._all_launches())
    _write_report(tmp, "model", rank, report, arrays if rank == 0 else None)

# (domain, planes) -> the Pallas kernels of qrag_tpu/ops/pallas/fused_scan.py
# that the instance replaces
KERNELS = {
    ("bf16", 1): "qrag_tpu/ops/pallas/fused_scan.py:62 (_packed_kernel), "
                 "qrag_tpu/ops/pallas/fused_scan.py:279 (_packed_t_kernel); float domain",
    ("bf16", 2): "qrag_tpu/ops/pallas/fused_scan.py:398 (_packed_top2_t_kernel), "
                 "qrag_tpu/ops/pallas/fused_scan.py:159 (_packed_top2_kernel)",
    ("bf16", 3): "qrag_tpu/ops/pallas/fused_scan.py:398 (_packed_top2_t_kernel, planes=3)",
    ("int8", 1): "qrag_tpu/ops/pallas/fused_scan.py:62 (_packed_kernel), "
                 "qrag_tpu/ops/pallas/fused_scan.py:279 (_packed_t_kernel); int8 domain",
    ("int8", 2): "qrag_tpu/ops/pallas/fused_scan.py:398 (_packed_top2_t_kernel, int8 arm)",
}


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--worker"]:  # one rank of phase 11
        return _worker(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smoke = Smoke(torch)
    smoke.host()
    smoke.build()
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        # a partial run while working on a kernel, e.g.
        # --only gather_vs_twin,scan_topk_vs_twin; it prints no result
        for name in sys.argv[2].split(","):
            getattr(smoke, name)()
        print(f"partial run ({sys.argv[2]}): {time.perf_counter() - t0:.1f} s")
        return 0
    smoke.kernel_vs_twin()
    smoke.int8_vs_twin()
    smoke.gather_vs_twin()
    smoke.scan_topk_vs_twin()
    smoke.exactness()
    smoke.exactness_int8()
    launches = smoke.main_path()
    launches.update(smoke.models_path())
    smoke.train_path()
    launches.update(smoke.accel_quantum_path())
    launches.update(smoke.modes_sharded_path())
    launches.update(smoke.multiprocess_path())
    kernels = []
    for key, replaces in KERNELS.items():
        row = smoke.kernel_rows[key + (1024,)]
        kernels.append({
            "name": f"packed_window_scan {key[0]} planes={key[1]} B=1024 ({row['arm']} arm)",
            "route": "cuda",
            "source": "qrag_tpu_torch/csrc/fused_scan.cu",
            "replaces": replaces,
            # 0: the float top-1 arm lies on no dispatched path
            "launches": launches.get(key, 0),
            "launches_ingest_path": launches.get(("ingest", key), 0),
            "launches_accel_path": launches.get(("accel", key), 0),
            "launches_quantum_path": launches.get(("quantum", key), 0),
            "launches_sharded_path": launches.get(("sharded", key), 0),
            "launches_multiprocess_path": launches.get(("multiprocess", key), 0),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # no single PyTorch call computes the packed top-P window
            # function; the GEMM alone (torch.matmul / torch._int_mm) is
            # given as a floor beside it
            "library_ms": None,
            "gemm_floor_ms": row["gemm_floor_ms"],
            "device_ms": row["device_ms"],
            "host_us": row["host_us"],
            "other_shapes": {
                f"B={b}": smoke.kernel_rows[key + (b,)] for b in (64, 1)
            },
        })
    gather_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "device_ms", "host_us", "library_device_ms", "library_host_us")
    row = smoke.kernel_rows[("gather_rows", 6400)]  # the routed path's B=64 x C=100
    kernels.append({
        "name": "gather_rows f32 M=6400 d=768",
        "route": "cuda",
        "source": "qrag_tpu_torch/csrc/gather_rows.cu",
        "replaces": "qrag_tpu/ops/pallas/gather_rows.py:34 (_gather_kernel), "
                    "qrag_tpu/ops/pallas/gather_rows.py:131 (_gather_bs_kernel)",
        "launches": launches["gather_rows"],
        "launches_ingest_path": launches[("ingest", "gather_rows")],
        "launches_accel_path": launches[("accel", "gather_rows")],
        "launches_quantum_path": launches[("quantum", "gather_rows")],
        "launches_sharded_path": launches[("sharded", "gather_rows")],
        "launches_multiprocess_path": launches[("multiprocess", "gather_rows")],
        **{key: row[key] for key in gather_keys},
        "other_shapes": {
            f"M={m}": {key: smoke.kernel_rows[("gather_rows", m)][key] for key in gather_keys}
            for m in (100, 102400)
        },
    })
    for b, k in ((1024, 10), (1, 100)):
        for arm in ("float32", "bfloat16"):
            row = smoke.kernel_rows[("scan_topk", arm, b)]
            kernels.append({
                "name": f"scan_topk {arm} l2 B={b} k={k} ({row['arm']} arm)",
                "route": "cuda",
                "source": "qrag_tpu_torch/csrc/scan_topk.cu",
                "replaces": "qrag_tpu/ops/pallas/scan_topk.py:74 (_scan_topk_kernel)",
                # 0 on the default path; the candidate selection of the
                # approx / verified / refined modes (phase 10)
                "launches": launches[("scan_topk", arm)],
                "launches_accel_path": launches[("accel", ("scan_topk", arm))],
                "launches_quantum_path": launches[("quantum", ("scan_topk", arm))],
                "launches_modes_path": launches[("modes", ("scan_topk", arm))],
                "launches_sharded_path": launches[("sharded", ("scan_topk", arm))],
                "launches_multiprocess_path": launches[("multiprocess", ("scan_topk", arm))],
                **{key: row[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_composite_ms", "library_composite_device_ms",
                    "library_composite_bf16_ms", "gemm_floor_ms",
                    "device_ms", "host_us", "timing_launches", "kernels_ms")},
            })
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
