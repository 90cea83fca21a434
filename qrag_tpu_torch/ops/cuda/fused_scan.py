"""Packed window scan: the Hopper kernel and its dispatch.

``packed_window_scan`` is the one entry point of every windowed scan of
the port: the bounded-exact fronts (``bounded_topk.window_bounds_bf16``
and ``window_bounds_int8``, ``int8_domain.exact_topk_int8_domain``) and
``window_scan.windowed_scan_topk``.  A CUDA tensor launches the CUDA C++
kernel of ``csrc/fused_scan.cu`` (which replaces the Pallas kernels
``_packed_top2_t_kernel``, ``_packed_top2_kernel``, ``_packed_kernel``
and ``_packed_t_kernel`` of ``qrag_tpu/ops/pallas/fused_scan.py``) or
raises; a CPU tensor runs the plain PyTorch twins
(``window_scan.packed_window_scan`` for planes=1,
``bounded_topk.packed_window_scan_top2/top3/top2_int`` otherwise).

Domains: bf16 queries and corpus (the float domain, planes 1-3, with
the affine terms ``alpha``, ``row_add`` and ``col_add``) or int8 codes
(planes 1-2, raw int32 dots, no affine terms).

``launches`` counts kernel launches per (domain, planes), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qrag_tpu_torch.ops.cuda import _launch
from qrag_tpu_torch.ops.window_scan import WINDOW

launches = {
    ("bf16", 1): 0, ("bf16", 2): 0, ("bf16", 3): 0,
    ("int8", 1): 0, ("int8", 2): 0,
}


def reset_launches() -> None:
    _launch.reset(launches)


def packed_window_scan(
    queries: torch.Tensor,  # (B, d) scan dtype
    corpus: torch.Tensor,  # (N, d) scan dtype; N % 128 == 0
    lane_rank: Optional[torch.Tensor],  # (1, N) int32 (plain twins only)
    row_add: Optional[torch.Tensor] = None,  # (1, N) f32 (float domain)
    col_add: Optional[torch.Tensor] = None,  # (B, 1) f32 (float domain)
    alpha: float = 1.0,
    planes: int = 2,
) -> Tuple[torch.Tensor, ...]:
    """``planes`` (B, N/128) int32 packed planes (top-1[, top-2[,
    top-3]] keys per window) of ``alpha * Q X^T + col_add + row_add``
    (float) or of the clamped raw int32 dots (int8)."""
    int_domain = corpus.dtype == torch.int8
    if (queries.dtype == torch.int8) != int_domain:
        raise TypeError(
            f"packed_window_scan: queries {queries.dtype} vs corpus "
            f"{corpus.dtype}; both int8 or neither"
        )
    if planes not in ((1, 2) if int_domain else (1, 2, 3)):
        raise ValueError(
            f"planes must be in {{1, 2}} (int8) or {{1, 2, 3}} (float), "
            f"got {planes}"
        )
    if int_domain and (row_add is not None or col_add is not None or alpha != 1.0):
        raise ValueError("int domain packs raw dots; no affine terms")
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        from qrag_tpu_torch.ops import bounded_topk, window_scan

        if planes == 1:
            return (
                window_scan.packed_window_scan(
                    queries, corpus, lane_rank, row_add, col_add, alpha
                ),
            )
        if int_domain:
            return bounded_topk.packed_window_scan_top2_int(
                queries, corpus, lane_rank
            )
        twin = (
            bounded_topk.packed_window_scan_top3
            if planes == 3
            else bounded_topk.packed_window_scan_top2
        )
        return twin(queries, corpus, lane_rank, row_add, col_add, alpha)
    return _launch_kernel(queries, corpus, row_add, col_add, alpha, planes, int_domain)


def _launch_kernel(queries, corpus, row_add, col_add, alpha, planes, int_domain):
    b, d = queries.shape
    n = corpus.shape[0]
    dev = corpus.device
    if dev.type != "cuda" or queries.device != dev:
        raise ValueError(
            f"packed_window_scan: queries on {queries.device}, corpus on "
            f"{dev}; the kernel needs both on one CUDA device"
        )
    dtype = torch.int8 if int_domain else torch.bfloat16
    if queries.dtype != dtype or corpus.dtype != dtype:
        raise TypeError(
            "packed_window_scan kernel takes bf16 or int8 queries and "
            f"corpus, got {queries.dtype} and {corpus.dtype}"
        )
    if corpus.ndim != 2 or corpus.shape[1] != d:
        raise ValueError(f"corpus {tuple(corpus.shape)} vs queries {(b, d)}")
    if b < 1 or n < WINDOW or n % WINDOW or d < 16 or d % 16:
        raise ValueError(
            f"kernel shapes: need B >= 1, N % 128 == 0, d % 16 == 0; got "
            f"B={b}, N={n}, d={d}"
        )
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("packed_window_scan kernel needs contiguous inputs")
    if queries.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("packed_window_scan kernel needs 16-byte aligned rows")
    nw = n // WINDOW
    outs = [
        torch.empty((b, nw), dtype=torch.int32, device=dev)
        for _ in range(planes)
    ]
    if int_domain:
        _launch.launch(
            "qrag_packed_window_scan_int8", dev, launches, ("int8", planes),
            queries.data_ptr(), corpus.data_ptr(), b, nw, d, planes,
            outs[0].data_ptr(), outs[-1].data_ptr(),
        )
    else:
        ra = _affine(row_add, n, dev, "row_add")
        ca = _affine(col_add, b, dev, "col_add")
        _launch.launch(
            "qrag_packed_window_scan", dev, launches, ("bf16", planes),
            queries.data_ptr(), corpus.data_ptr(), ra.data_ptr(),
            ca.data_ptr(), b, nw, d, float(alpha), planes,
            outs[0].data_ptr(), outs[min(1, planes - 1)].data_ptr(),
            outs[-1].data_ptr(),
        )
    return tuple(outs)


def _affine(t: Optional[torch.Tensor], size: int, dev, name: str) -> torch.Tensor:
    """(size,) contiguous f32 on ``dev``: zeros for None, else the
    reference's (1, N) / (B, 1) operand flattened."""
    if t is None:
        return torch.zeros((size,), dtype=torch.float32, device=dev)
    if t.numel() != size or t.device != dev or t.dtype != torch.float32:
        raise ValueError(
            f"{name}: expected {size} f32 values on {dev}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )
    return t.reshape(size).contiguous()
