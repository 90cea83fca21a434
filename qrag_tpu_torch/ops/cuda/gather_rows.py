"""Row gather: the Hopper kernel's wrapper and launch counter.

``gather_rows_cuda`` launches the CUDA C++ kernel of
``csrc/gather_rows.cu`` (which replaces the Pallas kernels
``_gather_kernel`` and ``_gather_bs_kernel`` of
``qrag_tpu/ops/pallas/gather_rows.py``) or raises.  The dispatch by
device and the plain twin live in ``qrag_tpu_torch.ops.gather_rows``.

``launches`` counts kernel launches, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import threading

import torch

launches = 0
_launch_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


def gather_rows_cuda(corpus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, d) = corpus[clamp(idx, 0, N-1)] for a contiguous 1-D int32 or
    int64 ``idx``, both on one CUDA device; raises otherwise."""
    global launches
    dev = corpus.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(
            f"gather_rows kernel: corpus on {dev}, idx on {idx.device}; it "
            "needs both on one CUDA device"
        )
    if corpus.ndim != 2 or idx.ndim != 1:
        raise ValueError(
            f"gather_rows kernel: corpus (N, d) and idx (M,), got "
            f"{tuple(corpus.shape)} and {tuple(idx.shape)}"
        )
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows kernel: idx int32 or int64, got {idx.dtype}")
    if not (corpus.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows kernel needs contiguous inputs")
    n, d = corpus.shape
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=corpus.dtype, device=dev)
    if m == 0 or d == 0:
        return out
    if n == 0:
        raise ValueError("gather_rows: no rows to gather from (N = 0)")
    from qrag_tpu_torch.ops.cuda._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qrag_gather_rows(
            corpus.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            m, n, d * corpus.element_size(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError {err}")
    with _launch_lock:
        launches += 1
    return out
