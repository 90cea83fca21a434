"""Row gather: the Hopper kernel's wrapper and launch counter.

``gather_rows_cuda`` launches the CUDA C++ kernel of
``csrc/gather_rows.cu`` (which replaces the Pallas kernels
``_gather_kernel`` and ``_gather_bs_kernel`` of
``qrag_tpu/ops/pallas/gather_rows.py``) or raises.  The dispatch by
device and the plain twin live in ``qrag_tpu_torch.ops.gather_rows``.

``launches`` counts kernel launches, so a run can show that its path
went through the kernel.  The launch itself goes through
``_launch.launch``, the path shared by the three kernel wrappers.
"""

from __future__ import annotations

import torch

from qrag_tpu_torch.ops.cuda import _launch

_counts = {"gather_rows": 0}
_INDEX_TYPES = (torch.int32, torch.int64)


def __getattr__(name: str):
    if name == "launches":  # read as ``gather_rows.launches``
        return _counts["gather_rows"]
    raise AttributeError(name)


def reset_launches() -> None:
    _launch.reset(_counts)


def gather_rows_cuda(corpus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, d) = corpus[clamp(idx, 0, N-1)] for a contiguous 1-D int32 or
    int64 ``idx``, both on one CUDA device; raises otherwise."""
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
    if idx.dtype not in _INDEX_TYPES:
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
    _launch.launch(
        "qrag_gather_rows", dev, _counts, "gather_rows",
        corpus.data_ptr(), idx.data_ptr(), idx.dtype == torch.int64, m, n,
        d * corpus.element_size(), out.data_ptr(),
    )
    return out
