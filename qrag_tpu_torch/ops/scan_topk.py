"""Fused scan + running top-k (PyTorch port of
``qrag_tpu.ops.pallas.scan_topk.pallas_scan_topk``).

The interface and return convention of the reference: (scores,
indices), L2 distances ascending or inner products descending, with
invalid slots at +inf / -inf.  Goodness is ``2 q.x - |q|^2 - |x|^2``
(l2) or ``q.x`` (ip), in f32, from bf16-rounded operands when
``compute_dtype`` is bf16.  Per query the k best rows by (goodness
desc, index asc) win, with k sentinel entries (finfo(f32).min, -1)
ahead of the corpus: rows masked by ``valid_rows`` never displace a
sentinel, so when fewer than k rows are valid the remaining slots hold
index -1 and an infinite score.  (The reference gives the same answer
when its corpus fits one VMEM tile; past the first tile its running
buffer re-picks its own first entry and repeats that index in those
slots.)

A CUDA tensor launches the Hopper kernel (``ops/cuda/scan_topk.py``,
``csrc/scan_topk.cu``) or raises; a CPU tensor runs the plain twin.
Like the reference, this is no dispatch target of ``flat_scan_topk``:
it is reached through ``scan_topk`` alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = torch.finfo(torch.float32).min  # the reference's sentinel
MAX_K = 1024  # the largest k the kernel's candidate buffers take
_TWIN_CHUNK = 256  # queries per (chunk, N) score matrix in the twin


def _prepare(queries, corpus, k, metric, corpus_sqnorms, valid_rows, compute_dtype):
    if queries.ndim != 2 or corpus.ndim != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"scan_topk: queries (B, d) and corpus (N, d), got "
            f"{tuple(queries.shape)} and {tuple(corpus.shape)}"
        )
    n = corpus.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"scan_topk needs 1 <= k <= N, got k={k}, N={n}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype float32 or bfloat16, got {compute_dtype}")
    q = queries.to(torch.float32).contiguous()
    x = corpus.to(torch.float32).contiguous()
    qsq = torch.sum(q * q, dim=1)
    xsq = (
        torch.sum(x * x, dim=1)
        if corpus_sqnorms is None
        else corpus_sqnorms.to(torch.float32).reshape(n).contiguous()
    )
    valid = None if valid_rows is None else valid_rows.to(torch.bool).reshape(n).contiguous()
    return q, qsq, x, xsq, valid


def plain_goodness_topk(
    q: torch.Tensor,  # (B, d) f32
    qsq: torch.Tensor,  # (B,) f32
    x: torch.Tensor,  # (N, d) f32
    xsq: torch.Tensor,  # (N,) f32
    valid: Optional[torch.Tensor],  # (N,) bool or None
    k: int,
    l2: bool,
    bf16: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the kernel: raw (B, k) goodness and int32
    indices, sentinel slots (finfo(f32).min, -1)."""
    if bf16:
        q = q.to(torch.bfloat16).to(torch.float32)
        x = x.to(torch.bfloat16).to(torch.float32)
    vals, idxs = [], []
    for s in range(0, q.shape[0], _TWIN_CHUNK):
        g = q[s : s + _TWIN_CHUNK] @ x.T
        if l2:
            g = (2.0 * g - qsq[s : s + _TWIN_CHUNK, None]) - xsq[None, :]
        keep = g > NEG
        if valid is not None:
            keep &= valid[None, :]
        g = torch.where(keep, g, NEG)
        v, i = torch.sort(g, dim=1, descending=True, stable=True)
        v, i = v[:, :k], i[:, :k]
        vals.append(v)
        idxs.append(torch.where(v > NEG, i, -1).to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def _finalize(vals: torch.Tensor, idx: torch.Tensor, metric: str):
    invalid = vals <= NEG / 2
    if metric == "l2":
        return torch.where(invalid, torch.inf, torch.clamp_min(-vals, 0.0)), idx
    return torch.where(invalid, -torch.inf, vals), idx


def plain_scan_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[torch.Tensor] = None,
    valid_rows: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scan_topk`` through the plain twin on any device."""
    q, qsq, x, xsq, valid = _prepare(
        queries, corpus, k, metric, corpus_sqnorms, valid_rows, compute_dtype
    )
    vals, idx = plain_goodness_topk(
        q, qsq, x, xsq, valid, k, metric == "l2", compute_dtype == torch.bfloat16
    )
    return _finalize(vals, idx, metric)


def scan_topk(
    queries: torch.Tensor,  # (B, d)
    corpus: torch.Tensor,  # (N, d)
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[torch.Tensor] = None,  # (N,)
    valid_rows: Optional[torch.Tensor] = None,  # (N,) bool
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + top-k: (B, k) scores (l2 distances ascending / ip
    descending, invalid slots +inf / -inf) and int32 indices."""
    q, qsq, x, xsq, valid = _prepare(
        queries, corpus, k, metric, corpus_sqnorms, valid_rows, compute_dtype
    )
    bf16 = compute_dtype == torch.bfloat16
    if q.device.type == "cpu" and x.device.type == "cpu":
        vals, idx = plain_goodness_topk(q, qsq, x, xsq, valid, k, metric == "l2", bf16)
    else:
        from qrag_tpu_torch.ops.cuda.scan_topk import scan_topk_cuda

        vals, idx = scan_topk_cuda(q, qsq, x, xsq, valid, k, metric == "l2", bf16)
    return _finalize(vals, idx, metric)
