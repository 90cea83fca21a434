"""Exact flat-index scan + top-k (PyTorch port of ``qrag_tpu.ops.topk``).

Both metrics reduce to a descending "goodness" selection: L2 goodness
is -d^2 = 2 q.x - |q|^2 - |x|^2, finalized to distances only at the API
edge (``_finalize``).

Every f32 product here runs in IEEE fp32: on Hopper a TF32 matmul keeps
~3 decimal digits, the same class of error as the TPU's DEFAULT-
precision f32 dot that the reference pins to HIGHEST.  The package
import refuses to load with TF32 matmuls enabled (``qrag_tpu_torch``).

Ties go to the LOWER index everywhere (``lax.top_k`` parity), which
``torch.topk`` does not promise: selection sorts stably instead.

Only the "exact" and "bounded" modes are ported; "approx", "verified"
and "refined" raise (ROADMAP.md, Queue 1 slice 5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NOT_PORTED = (
    "topk_mode {!r} is not ported to qrag_tpu_torch yet "
    "(ROADMAP.md, Queue 1 slice 5); use 'bounded' or 'exact'"
)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: values descending, ties to the
    lower index (a stable descending sort keeps index order among
    equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cosine_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Cosine similarity (B, d) x (N, d) -> (B, N) f32."""
    q = queries.to(torch.float32)
    c = corpus.to(torch.float32)
    qn = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    cn = c / torch.linalg.norm(c, dim=-1, keepdim=True).clamp_min(1e-12)
    return qn @ cn.T


def _goodness(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    metric: str,
    corpus_sqnorms: Optional[torch.Tensor],
    valid_rows: Optional[torch.Tensor],
) -> torch.Tensor:
    """Descending-is-better score matrix (B, N); L2 goodness = -d^2.

    Both operands are upcast to f32 before the product (exact for bf16
    inputs; ``bf16 @ bf16`` in torch would round every score to bf16),
    and the product runs in IEEE fp32."""
    q32 = queries.to(torch.float32)
    dots = q32 @ corpus.to(torch.float32).T
    if metric == "l2":
        if corpus_sqnorms is None:
            c32 = corpus.to(torch.float32)
            corpus_sqnorms = torch.sum(c32 * c32, dim=-1)
        q_sq = torch.sum(q32 * q32, dim=-1, keepdim=True)
        g = 2.0 * dots - q_sq - corpus_sqnorms[None, :].to(torch.float32)
    elif metric == "ip":
        g = dots
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if valid_rows is not None:
        g = torch.where(valid_rows[None, :], g, -torch.inf)
    return g


def goodness_topk(
    g: torch.Tensor, k: int, mode: str = "exact"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (descending, lower-index ties) of a goodness matrix."""
    if mode != "exact":
        raise NotImplementedError(_NOT_PORTED.format(mode))
    return top_k(g, k)


def _finalize(vals: torch.Tensor, idx: torch.Tensor, metric: str):
    if metric == "l2":
        dist = torch.where(
            torch.isneginf(vals), torch.inf, torch.clamp_min(-vals, 0.0)
        )
        return dist, idx
    return vals, idx


def flat_scan_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[torch.Tensor] = None,
    valid_rows: Optional[torch.Tensor] = None,
    mode: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact full-matrix scan: (scores, indices), distances ascending
    for "l2", inner products descending for "ip".  "bounded" reaching
    this generic dispatch (ineligible shapes) is the exact sort — both
    are exact, this one is just the sort."""
    g = _goodness(queries, corpus, metric, corpus_sqnorms, valid_rows)
    vals, idx = goodness_topk(g, k, "exact" if mode == "bounded" else mode)
    return _finalize(vals, idx, metric)
