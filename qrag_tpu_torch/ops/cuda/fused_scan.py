"""Packed window scan: the Hopper kernel and its dispatch.

``packed_window_scan`` is the one entry point of the bounded-exact
scan (``ops.bounded_topk.window_bounds_bf16``).  A CUDA tensor launches
the CUDA C++ kernel of ``csrc/fused_scan.cu`` (which replaces the
Pallas kernels ``_packed_top2_t_kernel`` and ``_packed_top2_kernel`` of
``qrag_tpu/ops/pallas/fused_scan.py``) or raises; a CPU tensor runs the
plain PyTorch twins ``bounded_topk.packed_window_scan_top2/top3``.

``launches`` counts kernel launches per plane count, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from qrag_tpu_torch.ops.window_scan import WINDOW

launches = {2: 0, 3: 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for p in launches:
            launches[p] = 0


def packed_window_scan(
    queries: torch.Tensor,  # (B, d) scan dtype
    corpus: torch.Tensor,  # (N, d) scan dtype; N % 128 == 0
    lane_rank: torch.Tensor,  # (1, N) int32 (plain twin only)
    row_add: Optional[torch.Tensor] = None,  # (1, N) f32
    col_add: Optional[torch.Tensor] = None,  # (B, 1) f32
    alpha: float = 1.0,
    planes: int = 2,
) -> Tuple[torch.Tensor, ...]:
    """``planes`` (B, N/128) int32 packed planes (top-1, top-2[, top-3]
    keys per window) of ``alpha * Q X^T + col_add + row_add``."""
    if planes not in (2, 3):
        raise ValueError(f"planes must be 2 or 3, got {planes}")
    if queries.dtype == torch.int8 or corpus.dtype == torch.int8:
        raise NotImplementedError(
            "the int8 domain of the packed window scan is not ported yet "
            "(ROADMAP.md, Queue 2 K1 int8 arm)"
        )
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        from qrag_tpu_torch.ops import bounded_topk

        twin = (
            bounded_topk.packed_window_scan_top3
            if planes == 3
            else bounded_topk.packed_window_scan_top2
        )
        return twin(queries, corpus, lane_rank, row_add, col_add, alpha)
    return _launch(queries, corpus, row_add, col_add, alpha, planes)


def _launch(queries, corpus, row_add, col_add, alpha, planes):
    b, d = queries.shape
    n = corpus.shape[0]
    dev = corpus.device
    if dev.type != "cuda" or queries.device != dev:
        raise ValueError(
            f"packed_window_scan: queries on {queries.device}, corpus on "
            f"{dev}; the kernel needs both on one CUDA device"
        )
    if queries.dtype != torch.bfloat16 or corpus.dtype != torch.bfloat16:
        raise TypeError(
            "packed_window_scan kernel takes bf16 queries and corpus, got "
            f"{queries.dtype} and {corpus.dtype}"
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
    ra = _affine(row_add, n, dev, "row_add")
    ca = _affine(col_add, b, dev, "col_add")
    nw = n // WINDOW
    outs = [
        torch.empty((b, nw), dtype=torch.int32, device=dev)
        for _ in range(planes)
    ]
    from qrag_tpu_torch.ops.cuda._build import load_library

    fn = load_library().qrag_packed_window_scan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            queries.data_ptr(), corpus.data_ptr(), ra.data_ptr(),
            ca.data_ptr(), b, nw, d, float(alpha), planes,
            outs[0].data_ptr(), outs[1].data_ptr(),
            outs[-1].data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"packed_window_scan kernel launch failed: cudaError {err}")
    with _launch_lock:
        launches[planes] += 1
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
