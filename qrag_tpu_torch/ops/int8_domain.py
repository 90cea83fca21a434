"""Own-domain int8 exact top-k (PyTorch port of ``qrag_tpu.ops.int8_domain``).

The corpus IS the int8 codes (plus one f32 scale per 128-row window),
the query is symmetrically int8-rounded once at the edge, and the
scoring function is *defined* as

    score(q, r) = fl32( (t * s_w) * f32(<q8, x8_r>_int32) )      (ip)
    goodness(q, r) = (2*score - qsq_deq) - xsq_deq_r             (l2)

i.e. the exact int32 dot of the rounded operands, scaled once in f32.
The packed planes carry the RAW int32 dots and the refinement computes
the same product of the same integers through the same f32 expression
(``_own_score``), so a plane bound and a refined score of one row agree
up to rounding dust: a relative epsilon of 1e-6 keeps the certificates
sound without a meaningful candidate band.

Downstream is the bounded-exact design of ``ops.bounded_topk``: top-C
windows by upper bound, exact candidate re-scoring of gathered CODES,
cert_a coverage, cert_b whole-window patches, 4x escalation on the same
planes, and the own-domain full-sort fallback (one host sync per tier).
Result contract: exact top-k values AND indices of the own-domain
scoring function, ties broken by lower global index.  Keys clipped at
2^23 void the bounds and route the batch to the full sort.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qrag_tpu_torch.ops.bounded_topk import topk_tiebreak
from qrag_tpu_torch.ops.quantize import quantize_rows
from qrag_tpu_torch.ops.topk import top_k
from qrag_tpu_torch.ops.window_scan import (
    _I32_MIN,
    _INT_CLAMP,
    WINDOW,
    exact_int_dots,
    pad_cols,
)

# full-sort query chunk (the reference's chunk of 64)
_SORT_CHUNK = 64


def quantize_query_int8(q32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 rounding — THE edge where the own-domain
    contract is entered (the per-window corpus scheme)."""
    return quantize_rows(q32)


def row_int_sqnorms(corpus_q8: torch.Tensor) -> torch.Tensor:
    """(N,) int32 sum(x8^2) per row — exact (<= d * 127^2 < 2^31)."""
    x = corpus_q8.to(torch.int32)
    return torch.sum(x * x, dim=1, dtype=torch.int32)


def _own_score(dot_i32, scale, qsq_deq, xsq_deq, metric: str):
    """THE own-domain scoring expression, shared verbatim by the plane
    bounds, the candidate/patch refinement and the full-sort fallback,
    so every evaluation of one row is the identical f32 expression."""
    s = scale * dot_i32.to(torch.float32)
    if metric == "l2":
        return (2.0 * s - qsq_deq) - xsq_deq
    return s


def _query_terms(queries: torch.Tensor):
    """(q8, t, qsq_deq (B, 1)) of the own-domain contract."""
    q8, t = quantize_query_int8(queries.to(torch.float32))
    qi = q8.to(torch.int32)
    qsq_deq = ((t * t) * torch.sum(qi * qi, dim=1).to(torch.float32))[:, None]
    return q8, t, qsq_deq


def _own_full_sort(
    q8, t, qsq_deq, corpus_q8, scale_rows, xsq_full, k, metric, valid_rows,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unconditional own-domain backstop: full top-k, chunked over
    queries."""
    vs, is_ = [], []
    for s in range(0, q8.shape[0], _SORT_CHUNK):
        dots = exact_int_dots(q8[s : s + _SORT_CHUNK], corpus_q8)
        scale = t[s : s + _SORT_CHUNK, None] * scale_rows[None, :]
        g = _own_score(
            dots, scale, qsq_deq[s : s + _SORT_CHUNK], xsq_full[None, :], metric
        )
        if valid_rows is not None:
            g = torch.where(valid_rows[None, :], g, -torch.inf)
        v, i = top_k(g, k)
        vs.append(v)
        is_.append(i)
    return torch.cat(vs, dim=0), torch.cat(is_, dim=0)


def full_topk_int8_domain(
    queries: torch.Tensor,  # (B, d) f32
    corpus_q8: torch.Tensor,  # (N, d_scan) int8
    window_scales: torch.Tensor,  # (NW,) f32
    row_isq: torch.Tensor,  # (N,) int32
    k: int,
    metric: str = "l2",
    valid_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpruned own-domain top-k — the small-corpus route and the oracle
    ``exact_topk_int8_domain`` is held to."""
    q8, t, qsq_deq = _query_terms(queries)
    scale_rows = window_scales.repeat_interleave(WINDOW)
    xsq_full = (scale_rows * scale_rows) * row_isq.to(torch.float32)
    return _own_full_sort(
        pad_cols(q8, corpus_q8.shape[1]), t, qsq_deq, corpus_q8, scale_rows,
        xsq_full, k, metric, valid_rows,
    )


def _refine_int8_domain(
    q8, t, qsq_deq, corpus_q8, window_scales, xsq_full,
    k: int, metric: str, valid_rows, C: int, F: int,
    *, ub, ub2, cand_live, lane1,
):
    """The bounded tail in the int8 own domain: candidate selection +
    exact int re-scoring + cert_a/cert_b + whole-window patches.
    Returns (vals, idx, fell_back tensor, n_patched tensor)."""
    b = q8.shape[0]
    dev = q8.device
    neg_inf = torch.tensor(-torch.inf, device=dev)

    ub = torch.where(cand_live, ub, neg_inf)
    sel_vals, wsel = top_k(ub, C)  # (B, C)
    cand_idx = wsel * WINDOW + lane1.gather(1, wsel)
    cand_ok = sel_vals > -torch.inf
    if valid_rows is not None:
        # int planes can surface an invalid argmax row (padding codes
        # carry dot 0); a valid runner-up is covered by the ub2 patches
        cand_ok = cand_ok & valid_rows[cand_idx]
    cand_idx = torch.where(cand_ok, cand_idx, 0)
    dots = exact_int_dots(q8, corpus_q8[cand_idx])  # (B, C) exact
    scale_c = t[:, None] * window_scales[wsel]
    cand_g = _own_score(dots, scale_c, qsq_deq, xsq_full[cand_idx], metric)
    cand_g = torch.where(cand_ok, cand_g, neg_inf)
    ck_vals, _ = topk_tiebreak(cand_g, cand_idx, k)
    thr = ck_vals[:, k - 1]  # (B,)

    # cert_a: every window that could clear thr is IN the selection
    count_a = (ub >= thr[:, None]).sum(dim=1)
    sel_qual = (sel_vals >= thr[:, None]).sum(dim=1)
    cert_a_fail = torch.any((count_a > C) | (count_a != sel_qual))

    # cert_b: windows whose SECOND row might clear thr -> whole-window
    # patch (2-argmax selection, as in bounded_topk)
    flags = ub2 >= thr[:, None]
    fcount = flags.sum(dim=1)
    prio = torch.where(flags, ub2, neg_inf)
    rows = torch.arange(b, device=dev)
    w0 = torch.argmax(prio, dim=1)
    prio_masked = prio.clone()
    prio_masked[rows, w0] = -torch.inf
    w1 = torch.argmax(prio_masked, dim=1)
    pw = torch.stack([w0, w1], dim=1)  # (B, 2)
    pv = torch.stack([prio[rows, w0], prio_masked[rows, w1]], dim=1)
    P = 2
    cert_b_fail = torch.any(fcount > P) | ((fcount > 0).sum() > F)

    # flagged-query compaction (top-F queries by flag count)
    _, qsel = top_k(fcount.to(torch.float32), F)  # (F,)
    q_active = fcount[qsel] > 0
    p_w = pw[qsel]  # (F, P)
    p_live = torch.isfinite(pv[qsel]) & q_active[:, None]
    p_lane1 = lane1[qsel].gather(1, p_w)
    p_w_safe = torch.where(p_live, p_w, 0)
    lanes = torch.arange(WINDOW, device=dev)[None, None, :]
    p_idx = p_w_safe[:, :, None] * WINDOW + lanes  # (F, P, WINDOW)
    p_dots = exact_int_dots(
        q8[qsel], corpus_q8[p_idx.reshape(F, P * WINDOW)]
    ).reshape(F, P, WINDOW)
    p_scale = (t[qsel][:, None] * window_scales[p_w_safe])[:, :, None]
    p_g = _own_score(
        p_dots, p_scale, qsq_deq[qsel][:, :, None], xsq_full[p_idx], metric
    )
    dead = (lanes == p_lane1[:, :, None]) | ~p_live[:, :, None]
    if valid_rows is not None:
        dead = dead | ~valid_rows[p_idx]
    p_g = torch.where(dead, neg_inf, p_g)

    extras_g = torch.full((b, P * WINDOW), -torch.inf, device=dev)
    extras_g[qsel] = p_g.reshape(F, P * WINDOW)
    extras_idx = torch.zeros((b, P * WINDOW), dtype=p_idx.dtype, device=dev)
    extras_idx[qsel] = p_idx.reshape(F, P * WINDOW)

    fell_back = cert_a_fail | cert_b_fail
    vals, idx = topk_tiebreak(
        torch.cat([cand_g, extras_g], dim=1),
        torch.cat([cand_idx, extras_idx], dim=1),
        k,
    )
    return vals, idx, fell_back, p_live.sum()


def exact_topk_int8_domain(
    queries: torch.Tensor,  # (B, d) f32 (rounded to int8 in-op)
    corpus_q8: torch.Tensor,  # (N, d_scan) int8 per-window codes; N % 128 == 0
    window_scales: torch.Tensor,  # (NW,) f32
    row_isq: torch.Tensor,  # (N,) int32 from row_int_sqnorms
    lane_rank: torch.Tensor,  # (1, N)
    k: int,
    metric: str = "l2",
    valid_rows: Optional[torch.Tensor] = None,  # (N,) bool
    candidates: int = 16,
    patch_queries: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor, bool, torch.Tensor, bool]:
    """Exact top-k of the OWN-DOMAIN int8 scoring function (module
    doc): (values, indices, fell_back, n_patched, escalated), the
    5-tuple of ``bounded_exact_topk``."""
    from qrag_tpu_torch.ops.cuda.fused_scan import packed_window_scan

    b = queries.shape[0]
    n = corpus_q8.shape[0]
    nw = n // WINDOW
    if nw < k:
        raise ValueError(
            f"bounded top-k needs >= k windows (k={k}, windows={nw}) — "
            "route small corpora to full_topk_int8_domain"
        )
    C = min(max(candidates, k), nw)
    F = min(patch_queries, b)
    q8, t, qsq_deq = _query_terms(queries)
    q8 = pad_cols(q8, corpus_q8.shape[1]).contiguous()

    pk1, pk2 = packed_window_scan(q8, corpus_q8, lane_rank, planes=2)
    dot1 = pk1 >> 7  # EXACT int dot of each window's argmax row
    lane1 = WINDOW - 1 - (pk1 & (WINDOW - 1))
    pk2_masked = pk2 == _I32_MIN
    dot2 = pk2 >> 7
    # a clipped key voids the upper bound: force the full sort
    clip_fail = torch.any(torch.abs(dot1) >= _INT_CLAMP) | torch.any(
        torch.where(pk2_masked, 0, torch.abs(dot2)) >= _INT_CLAMP
    )

    scale_rows = window_scales.repeat_interleave(WINDOW)  # (N,)
    xsq_full = (scale_rows * scale_rows) * row_isq.to(torch.float32)
    scale_bw = t[:, None] * window_scales[None, :]  # (B, NW)
    s1 = scale_bw * dot1.to(torch.float32)
    s2 = scale_bw * dot2.to(torch.float32)
    neg_inf = torch.tensor(-torch.inf, device=q8.device)
    if metric == "l2":
        minsq_src = xsq_full
        if valid_rows is not None:
            minsq_src = torch.where(valid_rows, xsq_full, torch.inf)
        minsq = minsq_src.reshape(nw, WINDOW).amin(dim=1)
        minsq = torch.where(torch.isfinite(minsq), minsq, 0.0)[None, :]
        # epsilon covers evaluating the identical plane and refine
        # expressions with different fusion (fma dust) — not a band
        eps = 1e-6 * (2.0 * torch.abs(s1) + qsq_deq + minsq) + 1e-30
        ub = (2.0 * s1 - qsq_deq) - minsq + eps
        ub2 = torch.where(pk2_masked, neg_inf, (2.0 * s2 - qsq_deq) - minsq + eps)
    elif metric == "ip":
        eps = 1e-6 * torch.abs(s1) + 1e-30
        ub = s1 + eps
        ub2 = torch.where(pk2_masked, neg_inf, s2 + eps)
    else:
        raise ValueError(f"unknown metric {metric!r}")

    cand_live = torch.ones((b, nw), dtype=torch.bool, device=q8.device)
    if valid_rows is not None:
        # windows with no valid row must not qualify (zero-padding
        # codes carry dot 0, beating real negative scores)
        wvalid = valid_rows.reshape(nw, WINDOW).any(dim=1)[None, :]
        ub = torch.where(wvalid, ub, neg_inf)
        ub2 = torch.where(wvalid, ub2, neg_inf)
        cand_live = wvalid.expand(b, nw)

    refine_args = (
        q8, t, qsq_deq, corpus_q8, window_scales, xsq_full, k, metric,
        valid_rows,
    )
    common = dict(ub=ub, ub2=ub2, cand_live=cand_live, lane1=lane1)

    def full_sort():
        return _own_full_sort(
            q8, t, qsq_deq, corpus_q8, scale_rows, xsq_full, k, metric,
            valid_rows,
        )

    vals, idx, fb1, npatch = _refine_int8_domain(*refine_args, C, F, **common)
    # one host sync for the tier: certified? bounds void?
    fb1, clip = torch.stack([fb1, clip_fail]).tolist()
    C2 = min(4 * C, nw)
    F2 = min(4 * F, b)
    if C2 <= C or clip or not fb1:
        # no escalation tier (or none needed); clipped keys void the
        # bounds, which escalation cannot fix: straight to the sort
        if fb1 or clip:
            vals, idx = full_sort()
        return vals, idx, fb1 or clip, npatch, False
    vals, idx, fb2, npatch = _refine_int8_domain(*refine_args, C2, F2, **common)
    fb2 = bool(fb2)
    if fb2:
        vals, idx = full_sort()
    return vals, idx, fb2, npatch, True
