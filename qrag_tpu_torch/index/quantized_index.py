"""Int8-quantized flat index: quantized scan + exact refinement (PyTorch
port of ``qrag_tpu.index.quantized_index``).

``QuantizedFlatIndex`` keeps TWO device-resident forms of the corpus:
int8 codes (+ scales) that the hot scan reads, and the true-precision
matrix (bf16 by default) used to exactly re-score the top candidates.
Returned scores are exact; only candidate recall depends on
quantization, controlled by ``refine_factor`` (candidates =
refine_factor x k).

Scan modes:

* ``scan="row"`` (default): per-row scales, one int8 matrix product
  (``torch._int_mm``) and a top-C over the rescaled scores
  (``ops.quantize.int8_scan_topk``).
* ``scan="window"``: the packed window-argmax scan (Hopper kernel,
  ``ops.window_scan.windowed_scan_topk``) over per-128-row-BLOCK codes;
  the (B, N) score matrix never exists.  ``exact_scores=False`` skips
  the candidate re-score (gather-free, approximate scores);
  ``domain_exact=True`` returns the exact top-k of the own-domain int8
  scoring function (``ops.int8_domain``).

The quantized buffers are attached by ``_finalize_snapshot``, inside
the index's atomic ``DeviceBuffers`` generation, so an append publishes
all forms of the corpus together.
"""

from __future__ import annotations

from typing import Tuple

import torch

from qrag_tpu_torch.index.flat_index import DeviceBuffers, DeviceFlatIndex
from qrag_tpu_torch.ops.quantize import (
    int8_scan_topk,
    quantize_rows,
    refine_candidates,
)
from qrag_tpu_torch.ops.topk import _finalize, flat_scan_topk
from qrag_tpu_torch.ops.window_scan import (
    WINDOW,
    make_lane_rank,
    pad_cols,
    quantize_block_rows_device,
    windowed_scan_topk,
)


class QuantizedFlatIndex(DeviceFlatIndex):
    """DeviceFlatIndex whose scan runs on int8 with exact refinement."""

    def __init__(
        self,
        *args,
        refine_factor: int = 4,
        scan: str = "row",
        exact_scores: bool = True,
        domain_exact: bool = False,
        **kwargs,
    ):
        kwargs.setdefault("store_dtype", "bfloat16")
        # the quantized scan is pre-refinement approximate; the fused
        # rerank's candidates come from the store matrix in this mode
        kwargs["topk_mode"] = "approx"
        if scan not in ("window", "row"):
            raise ValueError(f"unknown quantized scan mode {scan!r}")
        if not exact_scores and scan != "window":
            raise ValueError(
                "exact_scores=False (the gather-free mode) requires "
                "scan='window' — the row scan always refines"
            )
        if domain_exact and scan != "window":
            raise ValueError(
                "domain_exact=True needs scan='window' (the own-domain "
                "contract is defined over per-window codes — "
                "ops/int8_domain.py)"
            )
        super().__init__(*args, **kwargs)
        if scan == "window" and self.row_pad_multiple % WINDOW:
            raise ValueError(
                "window scan needs row_pad_multiple % 128 == 0 "
                f"(got {self.row_pad_multiple})"
            )
        if scan == "window":
            # the reference rounds capacity to its transposed Mosaic
            # kernel's 1024-row tile; kept so both packages pad alike
            self.row_pad_multiple = -(-self.row_pad_multiple // 1024) * 1024
        self.refine_factor = max(1, int(refine_factor))
        self.scan = scan
        self.exact_scores = bool(exact_scores)
        self.domain_exact = bool(domain_exact)

    def layout(self) -> dict:
        """Scan-mode observability for /stats."""
        return {
            "quantization": "int8",
            "scan": self.scan,
            "exact_scores": self.exact_scores,
            "refine_factor": self.refine_factor,
            "domain_exact": self.domain_exact,
        }

    def _finalize_snapshot(self, snap: DeviceBuffers) -> None:
        if self.scan == "window":
            from qrag_tpu_torch.ops.int8_domain import row_int_sqnorms

            q8, bscales = quantize_block_rows_device(snap.matrix)
            # zero columns up to d % 16 == 0 for the kernel (exact)
            q8 = pad_cols(q8, -(-self.d // 16) * 16).contiguous()
            snap.extras["int8w"] = (
                q8, bscales, make_lane_rank(q8.shape[0], q8.device),
            )
            if self.domain_exact:
                snap.extras["int8w_isq"] = row_int_sqnorms(q8)
        else:
            snap.extras["int8"] = quantize_rows(snap.matrix)

    def _search_domain_exact(
        self, snap: DeviceBuffers, q32: torch.Tensor, k: int, nw: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Own-domain int8 EXACT top-k (``ops/int8_domain.py``).  Cert
        events land in the counters the bounded mode uses."""
        from qrag_tpu_torch.ops.int8_domain import (
            exact_topk_int8_domain,
            full_topk_int8_domain,
        )

        x8, bscales, lane_rank = snap.extras["int8w"]
        row_isq = snap.extras["int8w_isq"]
        if nw < max(2 * k, 16):
            # small corpus: the pruned design can't cover top-k out of
            # so few windows; the full own-domain sort is cheap here
            vals, idx = full_topk_int8_domain(
                q32, x8, bscales, row_isq, k,
                metric=self.metric, valid_rows=snap.valid,
            )
            return _finalize(vals, idx, self.metric)
        vals, idx, fell_back, _, escalated = exact_topk_int8_domain(
            q32, x8, bscales, row_isq, lane_rank, k,
            metric=self.metric, valid_rows=snap.valid,
            candidates=max(16, k),
        )
        with self._stats_lock:
            self.fallback_rows += int(fell_back)
            self.bounded_escalations += int(escalated)
        return _finalize(vals, idx, self.metric)

    def search_device(
        self, queries: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        snap = self.device_buffers()
        q32 = queries.to(self.device, torch.float32)
        nw = snap.matrix.shape[0] // WINDOW
        if self.domain_exact:
            return self._search_domain_exact(snap, q32, k, nw)
        if self.scan == "window" and nw < max(16 * k, 64):
            # small corpus: one candidate per window can't cover top-k
            # without collisions, and the exact scan is cheap here
            return flat_scan_topk(
                q32.to(self.store_dtype), snap.matrix, k, metric=self.metric,
                corpus_sqnorms=snap.sqnorms, valid_rows=snap.valid,
            )
        if self.scan == "window":
            x8, bscales, lane_rank = snap.extras["int8w"]
            vals, idx = windowed_scan_topk(
                q32, x8, snap.matrix, lane_rank, k,
                metric=self.metric,
                corpus_sqnorms=snap.sqnorms,
                window_scale=bscales,
                ntotal=snap.ntotal,
                refine_factor=self.refine_factor,
                exact_scores=self.exact_scores,
            )
            return _finalize(vals, idx, self.metric)
        x8, scales = snap.extras["int8"]
        q8, q_scale = quantize_rows(q32)
        c = min(self.refine_factor * k, x8.shape[0])
        cand_g, idx = int8_scan_topk(
            q8, q_scale, x8, scales, c,
            metric=self.metric,
            corpus_sqnorms=snap.sqnorms,
            query_sqnorms=torch.sum(q32 * q32, dim=-1),
            valid_rows=snap.valid,
        )
        vals, idx = refine_candidates(
            q32, snap.matrix, idx, cand_g, k,
            metric=self.metric, corpus_sqnorms=snap.sqnorms,
        )
        return _finalize(vals, idx, self.metric)
