"""Candidate-row gather (PyTorch port of
``qrag_tpu.ops.pallas.gather_rows``).

``out[m] = corpus[clamp(idx[m], 0, N-1)]`` for rows of any dtype and
width; out-of-range and negative indices clamp, as in the reference, so
an invalid candidate slot fetches a real row that the caller masks.

A CUDA tensor launches the Hopper kernel (``ops/cuda/gather_rows.py``,
``csrc/gather_rows.cu``) or raises; a CPU tensor runs the plain twin
``plain_gather_rows``.  The reference's three entry points (in-kernel
DMA, its 2-D form, the BlockSpec form) share the one kernel here; its
``rows_per_block``, ``full_unroll`` and ``interpret`` are Mosaic
tunables and are not ported, nor is ``kernel_available``, a probe that
exists only to fall back.
"""

from __future__ import annotations

import torch

_kernel = None  # ops.cuda.gather_rows.gather_rows_cuda, bound at first use


def plain_gather_rows(corpus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain twin: (M, d) rows of ``corpus`` at the clamped 1-D
    ``idx``."""
    n = corpus.shape[0]
    if n == 0 and idx.numel():
        raise ValueError("gather_rows: no rows to gather from (N = 0)")
    return corpus[idx.long().clamp(0, max(n - 1, 0))]


def gather_rows(corpus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, d) = corpus[clamp(idx)] for a 1-D index list."""
    if idx.ndim != 1:
        raise ValueError(f"gather_rows: 1-D idx, got {tuple(idx.shape)}")
    if corpus.device.type == "cpu" and idx.device.type == "cpu":
        return plain_gather_rows(corpus, idx)
    global _kernel
    if _kernel is None:
        from qrag_tpu_torch.ops.cuda.gather_rows import gather_rows_cuda

        _kernel = gather_rows_cuda
    return _kernel(corpus, idx if idx.is_contiguous() else idx.contiguous())


def gather_rows_2d(corpus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, C, d) = corpus[clamp(idx)] — the candidate-gather shape."""
    b, c = idx.shape
    return gather_rows(corpus, idx.reshape(-1)).reshape(b, c, corpus.shape[1])


def gather_rows_blockspec(corpus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's BlockSpec form: the same function and kernel as
    ``gather_rows``."""
    return gather_rows(corpus, idx)
