"""Fused scan + running top-k: the Hopper kernel's wrapper and launch
counters.

``scan_topk_cuda`` launches the CUDA C++ kernels of
``csrc/scan_topk.cu`` (which replace the Pallas kernel
``_scan_topk_kernel`` of ``qrag_tpu/ops/pallas/scan_topk.py``) or
raises.  The dispatch by device and the plain twin live in
``qrag_tpu_torch.ops.scan_topk``.

It picks the kernel's query tile and candidate-buffer size from k and
B, splits the rows into about four blocks per SM, and allocates the
splits' scratch lists.  ``launches`` counts launches per arm.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from qrag_tpu_torch.ops.scan_topk import MAX_K

launches = {"float32": 0, "bfloat16": 0}
_launch_lock = threading.Lock()
_CHUNK = 64  # corpus rows per step of the kernel


def reset_launches() -> None:
    with _launch_lock:
        for key in launches:
            launches[key] = 0


def _config(b: int, n: int, k: int, sms: int) -> Tuple[int, int, int, int]:
    """(query tile, buffer entries, splits, rows per split)."""
    buf = 128
    while buf < k + _CHUNK:
        buf *= 2
    if buf <= 256:
        qt = 64 if b > 16 else 16
    else:
        qt = 8 if buf == 2048 else 16
    qtiles = -(-b // qt)
    splits = max(1, min(-(-4 * sms // qtiles), -(-n // _CHUNK)))
    rows = -(-n // splits)
    rows = -(-rows // _CHUNK) * _CHUNK
    return qt, buf, -(-n // rows), rows


def scan_topk_cuda(
    q: torch.Tensor,  # (B, d) f32
    qsq: torch.Tensor,  # (B,) f32
    x: torch.Tensor,  # (N, d) f32
    xsq: torch.Tensor,  # (N,) f32
    valid: Optional[torch.Tensor],  # (N,) bool or None
    k: int,
    l2: bool,
    bf16: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (B, k) goodness and int32 indices from the kernel; sentinel
    slots (finfo(f32).min, -1)."""
    dev = x.device
    tensors = [q, qsq, x, xsq] + ([] if valid is None else [valid])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "scan_topk kernel: every operand on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in (q, qsq, x, xsq)) or (
        valid is not None and valid.dtype != torch.bool
    ):
        raise TypeError("scan_topk kernel takes f32 operands and a bool mask")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("scan_topk kernel needs contiguous operands")
    b, d = q.shape
    n = x.shape[0]
    if k > MAX_K:
        raise ValueError(f"scan_topk kernel takes k <= {MAX_K}, got k={k}")
    if n >= 2**31:
        raise ValueError(f"scan_topk kernel indexes rows in int32, got N={n}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qt, buf, splits, rows = _config(b, n, k, sms)
    pv = torch.empty((splits, b, k), dtype=torch.float32, device=dev)
    pi = torch.empty((splits, b, k), dtype=torch.int32, device=dev)
    ov = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int32, device=dev)
    from qrag_tpu_torch.ops.cuda._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qrag_scan_topk(
            q.data_ptr(), qsq.data_ptr(), x.data_ptr(), xsq.data_ptr(),
            None if valid is None else valid.data_ptr(), b, n, d, k, int(l2),
            int(bf16), qt, buf, splits, rows, pv.data_ptr(), pi.data_ptr(),
            ov.data_ptr(), oi.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"scan_topk kernel launch failed: cudaError {err}")
    with _launch_lock:
        launches["bfloat16" if bf16 else "float32"] += 1
    return ov, oi
