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
Unlike the reference, where it is no dispatch target, the kernel is
the candidate selection of the "approx", "verified" and "refined"
modes of ``ops.topk`` (through ``scan_goodness_topk``): its selection
is exact, with ties to the lower index, where ``lax.approx_max_k`` is
approximate.

The kernel reads f32 rows.  A corpus stored in another dtype (the bf16
store) is upcast ``CAST_ROWS`` rows at a time, each block scanned on
its own and the blocks' top-k merged (``f32_blocks``): a call's
transient f32 copy is one block, not the store.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = torch.finfo(torch.float32).min  # the reference's sentinel
MAX_K = 1024  # the largest k the kernel's candidate buffers take
_TWIN_CHUNK = 256  # queries per (chunk, N) score matrix in the twin
# rows of a non-f32 corpus upcast at a time (384 MiB of f32 at d = 768)
CAST_ROWS = 131072


def f32_blocks(corpus: torch.Tensor):
    """(first row, rows as f32) over the corpus: the corpus itself when
    it is f32, else blocks of ``CAST_ROWS`` rows upcast one at a time
    (exact for bf16), so that the copy lives one block at a time."""
    if corpus.dtype == torch.float32:
        yield 0, corpus
        return
    for s in range(0, corpus.shape[0], CAST_ROWS):
        yield s, corpus[s : s + CAST_ROWS].to(torch.float32)


def _check(queries, corpus, k, metric, compute_dtype):
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


def _prepare(queries, corpus, k, metric, corpus_sqnorms, valid_rows, compute_dtype):
    """The kernel's operands for an f32 corpus (or block): f32 queries,
    their squared norms, the rows' squared norms and the mask."""
    _check(queries, corpus, k, metric, compute_dtype)
    if corpus.dtype != torch.float32:
        raise TypeError(f"the scan reads f32 rows (f32_blocks), got {corpus.dtype}")
    n = corpus.shape[0]
    q = queries.to(torch.float32).contiguous()
    x = corpus.contiguous()
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
    vals, idx = _blocked_topk(
        queries, corpus, k, metric, corpus_sqnorms, valid_rows, compute_dtype,
        plain_goodness_topk,
    )
    return _finalize(vals, idx, metric)


def _blocked_topk(queries, corpus, k, metric, corpus_sqnorms, valid_rows,
                  compute_dtype, select):
    """``select`` (the kernel or its twin) over each f32 block of the
    corpus (``f32_blocks``); the blocks' top-k merged by (goodness
    desc, row asc): blocks are in row order and a stable sort keeps it
    among equal values.  Raw (B, k) goodness and int32 rows."""
    _check(queries, corpus, k, metric, compute_dtype)
    l2, bf16 = metric == "l2", compute_dtype == torch.bfloat16
    sets = []
    for s, x in f32_blocks(corpus):
        e = s + x.shape[0]
        sq = None if corpus_sqnorms is None else corpus_sqnorms.reshape(-1)[s:e]
        vr = None if valid_rows is None else valid_rows.reshape(-1)[s:e]
        kb = min(k, e - s)
        vals, idx = select(*_prepare(queries, x, kb, metric, sq, vr, compute_dtype),
                           kb, l2, bf16)
        sets.append((vals, idx if s == 0 else torch.where(idx >= 0, idx + s, idx)))
        del x  # before the next block is cast: one block alive at a time
    if len(sets) == 1:
        return sets[0]
    vals, sel = torch.sort(torch.cat([v for v, _ in sets], dim=1), dim=1,
                           descending=True, stable=True)
    idx = torch.cat([i for _, i in sets], dim=1)
    return vals[:, :k].contiguous(), idx.gather(1, sel[:, :k])


def scan_goodness_topk(
    queries: torch.Tensor,  # (B, d)
    corpus: torch.Tensor,  # (N, d)
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[torch.Tensor] = None,  # (N,)
    valid_rows: Optional[torch.Tensor] = None,  # (N,) bool
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scan_topk`` before finalizing: raw (B, k) goodness descending
    and int32 indices, sentinel slots (finfo(f32).min, -1).  A CUDA
    tensor launches the kernel (k <= ``MAX_K``; once per f32 block),
    a CPU tensor runs the twin."""
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        select = plain_goodness_topk
    else:
        from qrag_tpu_torch.ops.cuda.scan_topk import scan_topk_cuda as select
    return _blocked_topk(
        queries, corpus, k, metric, corpus_sqnorms, valid_rows, compute_dtype, select
    )


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
    vals, idx = scan_goodness_topk(
        queries, corpus, k, metric, corpus_sqnorms, valid_rows, compute_dtype
    )
    return _finalize(vals, idx, metric)
