"""Provably-exact top-k via norm-bounded window pruning (PyTorch port).

Port of the float domain of ``qrag_tpu.ops.bounded_topk``; the module
doc there derives the design.  In short:

  1. ONE scan (``ops.cuda.fused_scan.packed_window_scan``: the Hopper
     kernel on a CUDA tensor, the plain twins below on a CPU tensor)
     emits per 128-row window the top-2 (top-3 at large k) packed
     (truncated score | lane) keys — (B, N/128) planes, 128x smaller
     than the score matrix.
  2. A rigorous per-window margin turns plane values into upper bounds
     on any row's refine-domain (f32) score.
  3. Top-C windows by bound give candidate rows, exactly re-scored; the
     k-th candidate score is a threshold.  Certificates (cert_a
     coverage, cert_b whole-window patches, cert_r runner-up rows at
     large k) prove nothing outside the scored set can beat it.
  4. A failed certificate re-certifies the SAME planes at 4x budgets;
     only if that fails too does the exact full sort run.

Result contract: the EXACT top-k (values, indices, ties to the lower
global index) of the refine-domain scoring function.

Where the JAX graph branches with ``lax.cond`` the port syncs ONE host
scalar per tier and runs the next tier only if needed, so the full sort
never runs on a batch that certified.  Window selection is an exact
stable sort (the TPU used ``approx_max_k`` past 4096 windows); cert_a
still counts coverage.  The int8 domain (``bounded_exact_topk_int8``)
is not ported yet (ROADMAP.md, Queue 1 slice 5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from qrag_tpu_torch.ops.topk import _goodness, top_k
from qrag_tpu_torch.ops.window_scan import (
    _I32_MIN,
    WINDOW,
    _float_from_key,
    _float_sort_key,
)

# worst-case relative f32 accumulation-order drift between two
# evaluations of the same d-term dot product (d * eps_f32 each, two
# evaluations, product-rounding dust), d <= ~8192.  It also covers the
# tensor-core f32 accumulation of the Hopper scan kernel, whose
# rounding mode is not documented as round-to-nearest.
_EPS_ACC = 2.4e-4
# bf16 has SEVEN fraction bits: round-to-nearest input error is
# <= 2^-8 * |x| per operand
_BF16_HALF_ULP = 2.0 ** -8
_SAFETY = 1.25
# k above which the large-k (top3 + runner-up) design engages by
# default: below it, expected window collisions (~k^2/2NW) stay well
# under the whole-window patch budget F
_LARGE_K_AUTO = 16
# plain-twin query chunk: bounds the (chunk, N) f32 score temporaries
_TWIN_ELEMS = 1 << 27


def window_maxnorms(corpus_sqnorms: np.ndarray) -> np.ndarray:
    """(NW,) f32: max row L2-norm per 128-row window (pad with 0)."""
    sq = np.asarray(corpus_sqnorms, np.float32)
    n = sq.shape[0]
    nw = -(-n // WINDOW)
    padded = np.zeros((nw * WINDOW,), np.float32)
    padded[:n] = sq
    return np.sqrt(padded.reshape(nw, WINDOW).max(axis=1))


def window_maxnorms_device(corpus_sqnorms: torch.Tensor) -> torch.Tensor:
    """Tensor twin of ``window_maxnorms`` (requires len % WINDOW == 0)."""
    return torch.sqrt(corpus_sqnorms.reshape(-1, WINDOW).amax(dim=1))


def margin_coeff(query_dtype, scan_dtype, exact_dtype, d: int) -> float:
    """Rigorous relative error coefficient between the scan evaluation
    and the refine evaluation of one dot product (module doc)."""
    q_round = 0.0 if query_dtype == scan_dtype else _BF16_HALF_ULP
    x_round = 0.0 if exact_dtype == scan_dtype else _BF16_HALF_ULP
    cross = 2.0 ** -16 if (q_round or x_round) else 0.0
    acc = max(d, 768) / 768.0 * _EPS_ACC
    return (q_round + x_round + cross + acc) * _SAFETY


def _packed_planes(queries, corpus, lane_rank, row_add, col_add, alpha, planes):
    """Plain twin of the scan kernel: ``planes`` successive masked
    window maxes of the packed keys.  Affine terms are added in the
    XLA twin's order, ``(alpha*g + row_add) + col_add``, so CPU planes
    match the JAX reference bit for bit where the products agree."""
    b, n = queries.shape[0], corpus.shape[0]
    nw = n // WINDOW
    x32 = corpus.to(torch.float32)
    chunk = max(1, _TWIN_ELEMS // max(n, 1))
    outs = [[] for _ in range(planes)]
    for s in range(0, b, chunk):
        g = queries[s : s + chunk].to(torch.float32) @ x32.T
        if alpha != 1.0:
            g = g * alpha
        if row_add is not None:
            g = g + row_add
        if col_add is not None:
            g = g + col_add[s : s + chunk]
        key = _float_sort_key(g) & ~127
        packed = (key | lane_rank).reshape(g.shape[0], nw, WINDOW)
        for p in range(planes):
            pk = packed.amax(dim=2)
            outs[p].append(pk)
            if p + 1 < planes:
                packed = torch.where(packed == pk[:, :, None], _I32_MIN, packed)
    return tuple(torch.cat(o, dim=0) for o in outs)


def packed_window_scan_top2(
    queries: torch.Tensor,  # (B, d) scan dtype (bf16/f32)
    corpus: torch.Tensor,  # (N, d) scan dtype; N % 128 == 0
    lane_rank: torch.Tensor,  # (1, N) from make_lane_rank
    row_add: Optional[torch.Tensor] = None,  # (1, N) f32
    col_add: Optional[torch.Tensor] = None,  # (B, 1) f32
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain top-2 window scan: (pk1, pk2) (B, NW) int32 packed planes
    — the window argmax key and the runner-up key."""
    return _packed_planes(queries, corpus, lane_rank, row_add, col_add, alpha, 2)


def packed_window_scan_top3(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    lane_rank: torch.Tensor,
    row_add: Optional[torch.Tensor] = None,
    col_add: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain top-3 window scan: ``packed_window_scan_top2`` plus the
    third-best plane (the large-k design's third-row bound)."""
    return _packed_planes(queries, corpus, lane_rank, row_add, col_add, alpha, 3)


def plane_value_bounds(pk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lower, upper) f32 bounds of the true scan score behind a packed
    plane entry: the trunc key is a lower bound, the next truncation
    step (+128 in the sign-folded int) a strict upper bound.  Fully-
    masked entries (INT32_MIN) map to (-inf, -inf)."""
    key = pk & ~127
    lo = _float_from_key(key)
    hi = _float_from_key(key + 128)
    masked = pk == _I32_MIN
    return (
        torch.where(masked, -torch.inf, lo),
        torch.where(masked, -torch.inf, hi),
    )


def topk_tiebreak(
    g: torch.Tensor, idx: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (goodness, global index) candidate lists: higher
    goodness first, ties -> lower global index (the two-key
    ``lax.sort`` of the reference): stable sort by index, then stable
    sort by goodness."""
    o = torch.argsort(idx, dim=1, stable=True)
    g, idx = g.gather(1, o), idx.gather(1, o)
    vals, o = torch.sort(g, dim=1, descending=True, stable=True)
    return vals[:, :k], idx.gather(1, o[:, :k])


def _exact_scores(
    q32: torch.Tensor,  # (B, d) f32
    rows: torch.Tensor,  # (B, ..., d) gathered corpus rows
    xsq: torch.Tensor,  # (B, ...) f32 sqnorms of those rows
    qsq: torch.Tensor,  # (B, 1) f32
    metric: str,
) -> torch.Tensor:
    """The refine-domain scoring function: f32 einsum + l2 identity."""
    dots = torch.einsum("bd,b...d->b...", q32, rows.to(torch.float32))
    if metric == "l2":
        return 2.0 * dots - qsq.reshape(qsq.shape[0], *([1] * (dots.ndim - 1))) - xsq
    return dots


def _auto_runner_budget(k: int, nw: int) -> int:
    """Default per-query runner-up row budget R: 4x the expected
    per-query double-collision count k^2/2NW, floored at 8."""
    return max(8, -(-4 * k * k // (2 * nw)))


def _auto_budgets(
    candidates: Optional[int], patch_queries: Optional[int],
    query_dtype, scan_dtype, refine_dtype, d: int,
) -> Tuple[int, int]:
    """Default (C, F) budgets by margin regime: narrow (16, 32), mid
    (48, 32), wide (96, 96).  The regime thresholds come from the
    reference's census (``qrag_tpu.ops.bounded_topk._auto_budgets``);
    values outside it self-correct through escalation."""
    coeff = margin_coeff(query_dtype, scan_dtype, refine_dtype, d)
    if coeff < 1e-3:
        c_def, f_def = 16, 32
    elif coeff < 7.5e-3:
        c_def, f_def = 48, 32
    else:
        c_def, f_def = 96, 96
    return (
        c_def if candidates is None else candidates,
        f_def if patch_queries is None else patch_queries,
    )


def bounded_exact_topk(
    queries: torch.Tensor,  # (B, d) f32 or scan dtype
    corpus_scan: torch.Tensor,  # (N, d_scan) bf16/f32 scan form; N % 128 == 0
    corpus_f: torch.Tensor,  # (N, d) refine-domain rows (may alias scan)
    corpus_sqnorms: torch.Tensor,  # (N,) f32 refine-domain row sqnorms
    maxnorms: torch.Tensor,  # (NW,) f32 from window_maxnorms
    lane_rank: torch.Tensor,  # (1, N)
    k: int,
    metric: str = "l2",
    valid_rows: Optional[torch.Tensor] = None,  # (N,) bool
    candidates: Optional[int] = None,
    patch_queries: Optional[int] = None,
    large_k: Optional[bool] = None,
    runner_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, bool, torch.Tensor, bool]:
    """Provably-exact top-k (module doc).

    Returns (goodness desc (B, k), indices (B, k) int64, fell_back
    (the exact full sort ran), n_patched (0-dim tensor), escalated (the
    4x-budget re-certification ran)).  ``corpus_scan`` may carry zero
    columns past d (the kernel needs d % 16 == 0); they add exact zeros
    to every dot."""
    b, d = queries.shape
    n = corpus_scan.shape[0]
    nw = n // WINDOW
    if nw < k:
        raise ValueError(
            f"bounded top-k needs >= k windows (k={k}, windows={nw}) — "
            "route small corpora to the exact sort"
        )
    C, F = _auto_budgets(
        candidates, patch_queries,
        queries.dtype, corpus_scan.dtype, corpus_f.dtype, d,
    )
    if large_k is None:
        large_k = k > _LARGE_K_AUTO
    if candidates is None and k > C:
        # auto budgets were censused at k=10; at larger k the margin
        # band rides ON TOP of the k qualifying windows
        C = k + C
    C = min(max(C, k), nw)
    F = min(F, b)
    R = (
        _auto_runner_budget(k, nw) if runner_rows is None else runner_rows
    ) if large_k else 8
    R = min(R, nw)
    P = 2
    if large_k:
        P = min(max(2, -(-4 * k**3 // (6 * nw * nw))), nw)

    bounds = window_bounds_bf16(
        queries, corpus_scan, corpus_f, corpus_sqnorms, maxnorms,
        lane_rank, metric=metric, valid_rows=valid_rows, top3=large_k,
    )
    q32, qsq, ub, ub2, cand_live, lane1 = bounds[:6]
    ub3, lane2, live2 = bounds[6:] if large_k else (None, None, None)
    return _certify_escalate(
        q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows, C, F,
        ub=ub, ub2=ub2, cand_live=cand_live, lane1=lane1,
        ub3=ub3, lane2=lane2, live2=live2, runner_budget=R,
        patch_windows=P,
    )


def window_bounds_bf16(
    queries: torch.Tensor,
    corpus_scan: torch.Tensor,
    corpus_f: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    maxnorms: torch.Tensor,
    lane_rank: torch.Tensor,
    metric: str = "l2",
    valid_rows: Optional[torch.Tensor] = None,
    top3: bool = False,
):
    """Float-scan front end: packed window scan + rigorous rounding
    margins.  Returns (q32, qsq, ub, ub2, cand_live, lane1), plus
    (ub3, lane2, live2) with ``top3`` — the certificate inputs of
    ``_certify_escalate``."""
    from qrag_tpu_torch.ops.cuda.fused_scan import packed_window_scan

    b, d = queries.shape
    q32 = queries.to(torch.float32)
    qsq = torch.sum(q32 * q32, dim=-1, keepdim=True)
    qnorm = torch.sqrt(qsq)

    alpha, row_add, col_add = 1.0, None, None
    if metric == "l2":
        alpha = 2.0
        row_add = -corpus_sqnorms[None, :].to(torch.float32)
        col_add = -qsq
    if valid_rows is not None:
        bias = torch.where(valid_rows, 0.0, -torch.inf)[None, :]
        row_add = bias if row_add is None else row_add + bias

    q_scan = queries.to(corpus_scan.dtype)
    if corpus_scan.shape[1] != d:
        q_scan = torch.nn.functional.pad(q_scan, (0, corpus_scan.shape[1] - d))
    pks = packed_window_scan(
        q_scan.contiguous(), corpus_scan, lane_rank,
        row_add=row_add, col_add=col_add, alpha=alpha,
        planes=3 if top3 else 2,
    )
    pk1, pk2 = pks[0], pks[1]
    v1_lb, v1_ub = plane_value_bounds(pk1)
    _, v2_ub = plane_value_bounds(pk2)

    coeff = alpha * margin_coeff(
        queries.dtype, corpus_scan.dtype, corpus_f.dtype, d
    )
    margin = coeff * qnorm * maxnorms[None, :] + 1e-30  # (B, NW)
    if metric == "l2":
        # the affine epilogue rounds in f32 with association orders
        # that differ between scan and refine; that drift scales with
        # the NORM TERMS, not |q||x|
        margin = margin + 5e-7 * (qsq + maxnorms[None, :] ** 2)

    lane1 = WINDOW - 1 - (pk1 & (WINDOW - 1))
    # an all-masked window's best score is exactly -inf (test the LOWER
    # bound: its +128-step upper bound is finite)
    base = (q32, qsq, v1_ub + margin, v2_ub + margin, v1_lb > -torch.inf, lane1)
    if not top3:
        return base
    v2_lb, _ = plane_value_bounds(pk2)
    _, v3_ub = plane_value_bounds(pks[2])
    lane2 = WINDOW - 1 - (pk2 & (WINDOW - 1))
    return base + (v3_ub + margin, lane2, v2_lb > -torch.inf)


def _certify_and_refine(
    q32: torch.Tensor,  # (B, d) f32 true queries
    qsq: torch.Tensor,  # (B, 1)
    corpus_f: torch.Tensor,  # (N, d) refine-domain rows
    corpus_sqnorms: torch.Tensor,  # (N,)
    k: int,
    metric: str,
    valid_rows: Optional[torch.Tensor],
    C: int,
    F: int,
    ub: torch.Tensor,  # (B, NW) bound for ANY row in the window
    ub2: torch.Tensor,  # (B, NW) bound for any NON-ARGMAX row
    cand_live: torch.Tensor,  # (B, NW) bool
    lane1: torch.Tensor,  # (B, NW) argmax lane
    do_fallback: bool = True,
    ub3: Optional[torch.Tensor] = None,  # (B, NW) bound for rows 3..W
    lane2: Optional[torch.Tensor] = None,  # (B, NW) runner-up lane
    live2: Optional[torch.Tensor] = None,  # (B, NW) runner-up exists
    runner_budget: int = 8,
    patch_windows: int = 2,
):
    """Certification tail: top-C window selection -> exact re-score ->
    certificates -> runner-up rows / window patches -> exact fallback
    (only when a certificate failed and ``do_fallback``).  Returns
    (vals, idx, fell_back tensor, n_patched tensor)."""
    b, d = q32.shape
    nw = ub.shape[1]
    dev = q32.device
    neg_inf = torch.tensor(-torch.inf, device=dev)

    # ---- candidates: top-C windows by upper bound, argmax rows exact
    ub = torch.where(cand_live, ub, neg_inf)
    sel_vals, wsel = top_k(ub, C)  # (B, C)
    cand_idx = wsel * WINDOW + lane1.gather(1, wsel)
    cand_ok = sel_vals > -torch.inf
    if valid_rows is not None:
        cand_ok = cand_ok & valid_rows[cand_idx]
    cand_idx = torch.where(cand_ok, cand_idx, 0)
    cand_g = _exact_scores(
        q32, corpus_f[cand_idx], corpus_sqnorms[cand_idx], qsq, metric
    )
    cand_g = torch.where(cand_ok, cand_g, neg_inf)
    ck_vals, _ = topk_tiebreak(cand_g, cand_idx, k)
    thr = ck_vals[:, k - 1]  # (B,)

    # ---- runner-up layer (large-k): a window whose SECOND row might
    # clear thr gets that one row exactly scored — R per query
    cert_r_fail = torch.zeros((), dtype=torch.bool, device=dev)
    runner_g = runner_idx = None
    if ub3 is not None:
        flags2 = (ub2 >= thr[:, None]) & live2
        prio2 = torch.where(flags2, ub2, neg_inf)
        R = min(runner_budget, nw)
        _, rsel = top_k(prio2, R)
        r_live = flags2.gather(1, rsel)
        r_idx = rsel * WINDOW + lane2.gather(1, rsel)
        r_idx = torch.where(r_live, r_idx, 0)
        if valid_rows is not None:
            r_live = r_live & valid_rows[r_idx]
        runner_g = torch.where(
            r_live,
            _exact_scores(
                q32, corpus_f[r_idx], corpus_sqnorms[r_idx], qsq, metric
            ),
            neg_inf,
        )
        runner_idx = r_idx
        count2 = flags2.sum(dim=1)
        cert_r_fail = torch.any((count2 > R) | (count2 != r_live.sum(dim=1)))
        # raise the threshold with the runner scores (still a lower
        # bound on the final k-th value) before the other certificates
        mk_vals, _ = topk_tiebreak(
            torch.cat([cand_g, runner_g], dim=1),
            torch.cat([cand_idx, runner_idx], dim=1),
            k,
        )
        thr = mk_vals[:, k - 1]

    # ---- cert_a: every window that could clear thr is IN the selection
    count_a = (ub >= thr[:, None]).sum(dim=1)
    sel_qual = (sel_vals >= thr[:, None]).sum(dim=1)
    cert_a_fail = torch.any((count_a > C) | (count_a != sel_qual))

    # ---- cert_b: windows whose SECOND (large-k: THIRD) row might clear
    # thr -> whole-window patch
    ubp = ub2 if ub3 is None else ub3
    flags = ubp >= thr[:, None]
    fcount = flags.sum(dim=1)  # (B,)
    prio = torch.where(flags, ubp, neg_inf)
    P = min(patch_windows, nw)
    if P == 2:
        rows = torch.arange(b, device=dev)
        w0 = torch.argmax(prio, dim=1)
        prio_masked = prio.clone()
        prio_masked[rows, w0] = -torch.inf
        w1 = torch.argmax(prio_masked, dim=1)
        pw = torch.stack([w0, w1], dim=1)  # (B, 2)
        # slot-1 liveness from the MASKED plane: with one flagged
        # window both argmaxes return it
        pv = torch.stack([prio[rows, w0], prio_masked[rows, w1]], dim=1)
    else:
        pv, pw = top_k(prio, P)
    n_flagged_q = (fcount > 0).sum()
    cert_b_fail = torch.any(fcount > P) | (n_flagged_q > F)

    # flagged-query compaction (top-F queries by flag count)
    _, qsel = top_k(fcount.to(torch.float32), F)  # (F,)
    q_active = fcount[qsel] > 0
    p_w = pw[qsel]  # (F, P)
    p_live = torch.isfinite(pv[qsel]) & q_active[:, None]
    p_lane1 = lane1[qsel].gather(1, p_w)
    lanes = torch.arange(WINDOW, device=dev)[None, None, :]
    p_idx = torch.where(p_live, p_w, 0)[:, :, None] * WINDOW + lanes
    p_g = _exact_scores(
        q32[qsel], corpus_f[p_idx], corpus_sqnorms[p_idx], qsq[qsel], metric
    )  # (F, P, WINDOW)
    dead = (lanes == p_lane1[:, :, None]) | ~p_live[:, :, None]
    if ub3 is not None:
        # large-k: the patched window's runner-up was scored by the
        # runner layer — mask it or the merge holds it twice
        p_lane2 = lane2[qsel].gather(1, p_w)
        dead = dead | (lanes == p_lane2[:, :, None])
    if valid_rows is not None:
        dead = dead | ~valid_rows[p_idx]
    p_g = torch.where(dead, neg_inf, p_g)

    extras_g = torch.full((b, P * WINDOW), -torch.inf, device=dev)
    extras_g[qsel] = p_g.reshape(F, P * WINDOW)
    extras_idx = torch.zeros((b, P * WINDOW), dtype=p_idx.dtype, device=dev)
    extras_idx[qsel] = p_idx.reshape(F, P * WINDOW)

    n_patched = p_live.sum()
    fell_back = cert_a_fail | cert_r_fail | cert_b_fail

    parts_g, parts_i = [cand_g, extras_g], [cand_idx, extras_idx]
    if runner_g is not None:
        parts_g.insert(1, runner_g)
        parts_i.insert(1, runner_idx)
    vals, idx = topk_tiebreak(
        torch.cat(parts_g, dim=1), torch.cat(parts_i, dim=1), k
    )
    if do_fallback and bool(fell_back):
        vals, idx = _exact_full_sort(
            q32, corpus_f, corpus_sqnorms, k, metric, valid_rows
        )
    return vals, idx, fell_back, n_patched


def _exact_full_sort(
    q32: torch.Tensor,
    corpus_f: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    k: int,
    metric: str,
    valid_rows: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unconditional-exactness backstop: full IEEE-fp32 top-k sort,
    chunked over queries so it holds (128, N) scores at a time."""
    vs, is_ = [], []
    for s in range(0, q32.shape[0], 128):
        g = _goodness(q32[s : s + 128], corpus_f, metric, corpus_sqnorms, valid_rows)
        v, i = top_k(g, k)
        vs.append(v)
        is_.append(i)
    return torch.cat(vs, dim=0), torch.cat(is_, dim=0)


def _certify_escalate(
    q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows, C, F,
    *, ub, ub2, cand_live, lane1,
    ub3=None, lane2=None, live2=None, runner_budget=8, patch_windows=2,
):
    """Escalating-budget certification: try C, then 4C on the SAME
    planes, then the exact full sort.  Each tier ends in one host
    scalar sync that decides whether the next one runs.  Returns the
    5-tuple of ``bounded_exact_topk``."""
    b = q32.shape[0]
    nw = ub.shape[1]
    common = dict(
        ub=ub, ub2=ub2, cand_live=cand_live, lane1=lane1,
        ub3=ub3, lane2=lane2, live2=live2,
    )
    C2 = min(4 * C, nw)
    F2 = min(4 * F, b)
    R2 = min(4 * runner_budget, nw)
    # the per-query patch-window cap only widens in large-k mode
    P2 = patch_windows if ub3 is None else min(4 * patch_windows, nw)
    if C2 <= C and (
        ub3 is None or (R2 <= runner_budget and P2 <= patch_windows)
    ):
        vals, idx, fb, npatch = _certify_and_refine(
            q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows,
            C, F, runner_budget=runner_budget,
            patch_windows=patch_windows, **common,
        )
        return vals, idx, bool(fb), npatch, False

    vals, idx, fb1, npatch = _certify_and_refine(
        q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows,
        C, F, do_fallback=False, runner_budget=runner_budget,
        patch_windows=patch_windows, **common,
    )
    if not bool(fb1):
        return vals, idx, False, npatch, False
    vals, idx, fb, npatch = _certify_and_refine(
        q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows,
        C2, F2, runner_budget=R2, patch_windows=P2, **common,
    )
    return vals, idx, bool(fb), npatch, True
