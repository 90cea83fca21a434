"""Int8 symmetric quantization for the retrieval scan (PyTorch port of
``qrag_tpu.ops.quantize``).

  * corpus: per-row symmetric scale s_i = max|x_i| / 127,
    q_i = round(x_i / s_i) (int8, round half to even)
  * queries: per-query scale likewise
  * scores:  dot(x_i, q_b) ~= s_i * t_b * (Q8 @ X8^T)[b, i]
  * selection: top-C on the rescaled scores (cast to bf16 first, as the
    reference does), then exact refinement: gather the true-precision
    candidate rows and re-score — recall governed by C, final scores
    exact.

The int8 product is a plain matrix product outside any kernel of the
reference (an XLA ``dot_general``); here it is ``torch._int_mm``.
Selection is an exact stable sort: ties go to the lower index, where
the reference's ``approx_max_k`` breaks bf16 ties its own way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from qrag_tpu_torch.ops.topk import top_k
from qrag_tpu_torch.ops.window_scan import pad_cols


# Inside jit, where the reference quantizes, XLA turns the division by
# the constant 127 into a multiply by its f32 reciprocal; the port does
# the same so that codes and scales agree bit for bit.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: returns (q8 (N, d), scales (N,) f32)."""
    x = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.where(absmax > 0, absmax * INV_127, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matmul(q8: torch.Tensor, x8: torch.Tensor) -> torch.Tensor:
    """(B, N) exact int32 ``q8 @ x8.T`` via ``torch._int_mm``, whose
    CUDA form needs M > 16 and K, N multiples of 8: the batch and the
    depth are zero-padded (exact) and the padding sliced off."""
    b, n = q8.shape[0], x8.shape[0]
    d = _round8(max(q8.shape[1], x8.shape[1]))
    m = max(_round8(b), 24)
    a = torch.nn.functional.pad(pad_cols(q8, d), (0, 0, 0, m - b))
    x = pad_cols(x8, d)
    if n % 8:
        x = torch.nn.functional.pad(x, (0, 0, 0, _round8(n) - n))
    return torch._int_mm(a.contiguous(), x.contiguous().T)[:b, :n]


def int8_scan_topk(
    q8: torch.Tensor,  # (B, d) int8
    q_scale: torch.Tensor,  # (B,) f32
    x8: torch.Tensor,  # (N, d) int8
    x_scale: torch.Tensor,  # (N,) f32
    k: int,
    metric: str = "ip",
    corpus_sqnorms: Optional[torch.Tensor] = None,  # f32 true sqnorms (l2)
    query_sqnorms: Optional[torch.Tensor] = None,
    valid_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized scan + top-k: ("goodness" desc, idx).  Scores are
    approximate (int8 dot, true scales); for "l2" the goodness is
    -(qsq + xsq - 2*dot) with exact norms."""
    dots = int8_matmul(q8, x8).to(torch.float32)
    dots = dots * q_scale[:, None] * x_scale[None, :]
    if metric == "l2":
        if corpus_sqnorms is None or query_sqnorms is None:
            raise ValueError("l2 needs true sqnorms for both sides")
        g = 2.0 * dots - query_sqnorms[:, None] - corpus_sqnorms[None, :]
    else:
        g = dots
    if valid_rows is not None:
        g = torch.where(valid_rows[None, :], g, -torch.inf)
    # bf16 goodness into the selector (the reference halves its (B, N)
    # selection traffic this way); exact refinement restores exact
    # final scores, and its ties decide the candidate set
    vals, idx = top_k(g.to(torch.bfloat16), k)
    return vals.to(torch.float32), idx


def refine_candidates(
    queries_f: torch.Tensor,  # (B, d) f32/bf16 true queries
    corpus_f: torch.Tensor,  # (N, d) true-precision corpus
    idx: torch.Tensor,  # (B, C) candidate indices
    cand_goodness: torch.Tensor,  # (B, C) quantized goodness (-inf invalid)
    k: int,
    metric: str = "ip",
    corpus_sqnorms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring of gathered candidates -> final top-k.
    Returns goodness (desc) and indices."""
    cand = corpus_f[idx].to(torch.float32)  # (B, C, d)
    q32 = queries_f.to(torch.float32)
    dots = torch.einsum("bd,bcd->bc", q32, cand)
    if metric == "l2":
        if corpus_sqnorms is None:
            xsq = torch.sum(cand * cand, dim=-1)
        else:
            xsq = corpus_sqnorms[idx]
        qsq = torch.sum(q32 * q32, dim=-1, keepdim=True)
        g = 2.0 * dots - qsq - xsq
    else:
        g = dots
    g = torch.where(torch.isneginf(cand_goodness), -torch.inf, g)
    vals, sel = top_k(g, k)
    return vals, idx.gather(1, sel)
