"""Windowed scan + selection (PyTorch port of ``qrag_tpu.ops.window_scan``).

Each 128-row window of the (B, N) score matrix reduces to int32 keys
that carry an order-preserving image of the score in the high bits and
``127 - lane`` in the low 7 bits, so a plain integer max picks the best
row and breaks ties toward the LOWER global index:

    float: key = sign-fold(bitcast_int32(score)) & ~127
    int8:  key = clip(int32 dot, +-(2^23 - 1)) << 7   (exact)
    packed = key | (127 - (row % 128))

``windowed_scan_topk`` selects the top-C windows of those planes and
re-scores their argmax rows exactly (or, gather-free, ranks by the
plane values).  The scan is ``ops.cuda.fused_scan.packed_window_scan``:
the Hopper kernel on a CUDA tensor, ``packed_window_scan`` below (the
plain twin) on a CPU tensor.

Window selection is an exact stable sort (ties to the lower window);
the reference used ``approx_max_k`` past 4096 windows, which has no
torch counterpart.  Int8 corpora use per-128-row-block scales
(``quantize_block_rows*``) so raw int32 dots order correctly within a
window; the scale rejoins at the plane level.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

WINDOW = 128
_I32_MIN = -(2 ** 31)
_INT_CLAMP = (1 << 23) - 1  # |key| <= 2^23 so << 7 never overflows
# plain-twin query chunk: bounds the (chunk, N) score temporaries
_TWIN_ELEMS = 1 << 27


def _float_sort_key(x_f32: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> int32 (IEEE sign-fold)."""
    u = x_f32.to(torch.float32).view(torch.int32)
    return torch.where(u < 0, _I32_MIN - u, u)


def _float_from_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_float_sort_key`` (low bits already cleared)."""
    u = torch.where(key < 0, _I32_MIN - key, key)
    return u.view(torch.float32)


def make_lane_rank(
    n: int, device: Optional[torch.device] = None
) -> torch.Tensor:
    """(1, N) int32 lane-rank plane: 127 - (col % 128), so packed ties
    resolve to the LOWER global index (``lax.top_k`` parity)."""
    cols = torch.arange(n, dtype=torch.int32, device=device)
    return (127 - cols % WINDOW)[None, :]


def unpack_stats(
    wstat: torch.Tensor, int_domain: bool, int_shift: int = 7
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, NW) packed -> (approx score f32 / int32-scaled, lane idx)."""
    lane = WINDOW - 1 - (wstat & (WINDOW - 1))
    if int_domain:
        return (wstat >> int_shift).to(torch.float32), lane
    return _float_from_key(wstat & ~(WINDOW - 1)), lane


def pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the last axis to ``width`` (a no-op when it matches):
    scan copies carry zero columns up to d % 16 == 0 for the kernel,
    which add exact zeros to every dot."""
    extra = width - t.shape[-1]
    return F.pad(t, (0, extra)) if extra else t


def exact_int_dots(q8: torch.Tensor, x8: torch.Tensor) -> torch.Tensor:
    """(B, N) exact int32 dots of int8 codes (``x8`` may be (N, d) or
    batched (B, M, d), giving (B, M)).  Computed in float64, exact
    while |dot| < 2^53 — far above d * 127^2; PyTorch has no CUDA
    int32 matmul."""
    q64 = q8.to(torch.float64)
    if x8.ndim == 3:
        dots = torch.bmm(x8.to(torch.float64), q64[:, :, None])[:, :, 0]
    else:
        dots = q64 @ x8.to(torch.float64).T
    return dots.to(torch.int32)


def _window_planes(queries, corpus, lane_rank, row_add, col_add, alpha, planes):
    """Plain twin of the scan kernel: ``planes`` successive masked
    window maxes of the packed keys, float or int8 domain.  Float affine
    terms are added in the XLA twin's order, ``(alpha*g + row_add) +
    col_add``, so CPU planes match the JAX reference bit for bit where
    the products agree; int planes are exact everywhere."""
    b, n = queries.shape[0], corpus.shape[0]
    nw = n // WINDOW
    int_domain = corpus.dtype == torch.int8
    xs = corpus if int_domain else corpus.to(torch.float32)
    chunk = max(1, _TWIN_ELEMS // max(n, 1))
    outs = [[] for _ in range(planes)]
    for s in range(0, b, chunk):
        if int_domain:
            dots = exact_int_dots(queries[s : s + chunk], xs)
            key = torch.clamp(dots, -_INT_CLAMP, _INT_CLAMP) * 128
        else:
            g = queries[s : s + chunk].to(torch.float32) @ xs.T
            if alpha != 1.0:
                g = g * alpha
            if row_add is not None:
                g = g + row_add
            if col_add is not None:
                g = g + col_add[s : s + chunk]
            key = _float_sort_key(g) & ~127
        packed = (key | lane_rank).reshape(key.shape[0], nw, WINDOW)
        for p in range(planes):
            pk = packed.amax(dim=2)
            outs[p].append(pk)
            if p + 1 < planes:
                packed = torch.where(packed == pk[:, :, None], _I32_MIN, packed)
    return tuple(torch.cat(o, dim=0) for o in outs)


def packed_window_scan(
    queries: torch.Tensor,  # (B, d) int8 or bf16/f32
    corpus: torch.Tensor,  # (N, d) same family; N % 128 == 0
    lane_rank: torch.Tensor,  # (1, N) int32 from make_lane_rank
    row_add: Optional[torch.Tensor] = None,  # (1, N) f32 (float domain only)
    col_add: Optional[torch.Tensor] = None,  # (B, 1) f32 (float domain only)
    alpha: float = 1.0,  # float-domain dots multiplier (2.0 for l2)
) -> torch.Tensor:
    """Plain top-1 window scan: (B, N/128) packed int32 window stats.
    Float domain scores ``alpha*dots + row_add + col_add``; the int
    domain packs raw int32 dots clamped to 24 bits."""
    return _window_planes(queries, corpus, lane_rank, row_add, col_add, alpha, 1)[0]


def windowed_scan_topk(
    queries: torch.Tensor,  # (B, d) f32 true queries (or int8 codes with q_scale)
    corpus_scan: torch.Tensor,  # (N, d_scan) int8 / bf16 / f32 scan form
    corpus_f: torch.Tensor,  # (N, d) true-precision rows for refinement
    lane_rank: torch.Tensor,  # (1, N) from make_lane_rank
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[torch.Tensor] = None,
    window_scale: Optional[torch.Tensor] = None,  # (NW,) int8 block scales
    q_scale: Optional[torch.Tensor] = None,  # (B,) int8 query scales
    ntotal: Optional[int] = None,  # rows >= ntotal are padding
    valid_rows: Optional[torch.Tensor] = None,  # (N,) bool; float domain only
    refine_factor: int = 8,
    exact_scores: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan -> top-C windows -> exact re-score -> top-k.

    Returns (goodness desc, indices); finalize to distances at the API
    edge.  Selection ranks by dot product (for l2 the int domain ranks
    by dot: the true order on constant-norm corpora); refinement
    applies the exact metric, so returned scores are exact.

    ``exact_scores=False`` is the gather-free mode: scores come straight
    from the planes (int8 domain: block-quantized, ~1%) and corpus_f is
    never touched.  ``corpus_scan`` may carry zero columns past d."""
    from qrag_tpu_torch.ops.cuda.fused_scan import packed_window_scan as scan

    n = corpus_scan.shape[0]
    nw = n // WINDOW
    dev = corpus_scan.device
    int_domain = corpus_scan.dtype == torch.int8

    # float domain + l2: fold the exact goodness corrections into the
    # scan epilogue so selection is exact-l2-ordered (the int domain
    # can't — per-window scales; its l2 selection ranks by dot)
    alpha, row_add, col_add = 1.0, None, None
    if not int_domain and metric == "l2" and corpus_sqnorms is not None:
        alpha = 2.0
        row_add = -corpus_sqnorms[None, :].to(torch.float32)
        q32_tmp = queries.to(torch.float32)
        col_add = -torch.sum(q32_tmp * q32_tmp, dim=-1, keepdim=True)
    if valid_rows is not None:
        if int_domain:
            raise ValueError(
                "valid_rows masks the float domain only; the int8 path "
                "uses `ntotal` (trailing-padding contract)"
            )
        bias = torch.where(valid_rows.to(torch.bool), 0.0, -torch.inf)[None, :]
        row_add = bias if row_add is None else row_add + bias

    if int_domain:
        from qrag_tpu_torch.ops.quantize import quantize_rows

        if q_scale is None:
            q8, q_scale = quantize_rows(queries.to(torch.float32))
        else:
            q8 = queries
        (wstat,) = scan(
            pad_cols(q8, corpus_scan.shape[1]).contiguous(), corpus_scan,
            lane_rank, planes=1,
        )
        raw, lanes = unpack_stats(wstat, int_domain=True)
        # rejoin scales at the plane level (per-window corpus scale x
        # per-query scale)
        wvals = raw * (window_scale[None, :] * q_scale[:, None])
    else:
        q_in = pad_cols(queries.to(corpus_scan.dtype), corpus_scan.shape[1])
        (wstat,) = scan(
            q_in.contiguous(), corpus_scan, lane_rank,
            row_add=row_add, col_add=col_add, alpha=alpha, planes=1,
        )
        wvals, lanes = unpack_stats(wstat, int_domain=False)

    window_base = (torch.arange(nw, dtype=torch.int64, device=dev) * WINDOW)[None, :]
    wind_idx = window_base + lanes  # (B, NW) global row of each window max

    if ntotal is not None:
        # windows fully past ntotal can never contribute
        wvals = torch.where(window_base < ntotal, wvals, -torch.inf)

    from qrag_tpu_torch.ops.topk import top_k

    c = min(refine_factor * k, nw)
    sv, si = top_k(wvals, c)
    cand_idx = wind_idx.gather(1, si)
    cand_ok = torch.isfinite(sv)
    if ntotal is not None:
        # the boundary window's argmax may be a padding row
        cand_ok = cand_ok & (cand_idx < ntotal)

    if not exact_scores:
        # gather-free: rank by the scan-domain plane values directly
        vals, sel = top_k(torch.where(cand_ok, sv, -torch.inf), k)
        idx_out = cand_idx.gather(1, sel)
        if int_domain and metric == "l2" and corpus_sqnorms is not None:
            # the int8 plane carries (quantized) DOT products: convert
            # the k winners to l2 goodness via 2*dot - |q|^2 - |x|^2,
            # with |q|^2 from the dequantized codes
            q_deq = q8.to(torch.float32) * q_scale[:, None]
            qsq = torch.sum(q_deq * q_deq, dim=-1, keepdim=True)
            xsq = corpus_sqnorms.to(torch.float32)[idx_out]
            vals = torch.where(torch.isfinite(vals), 2.0 * vals - qsq - xsq, vals)
            # not monotone in dot when norms vary: re-sort the k
            # winners in the returned domain (ties -> lower index)
            from qrag_tpu_torch.ops.bounded_topk import topk_tiebreak

            vals, idx_out = topk_tiebreak(vals, idx_out, k)
        return vals, idx_out

    from qrag_tpu_torch.ops.quantize import refine_candidates

    return refine_candidates(
        queries.to(torch.float32),
        corpus_f,
        cand_idx,
        torch.where(cand_ok, 0.0, -torch.inf),
        k,
        metric=metric,
        corpus_sqnorms=corpus_sqnorms,
    )


def quantize_block_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-128-row-block symmetric int8 quantization on the host (the
    blocks coincide with selection windows, so raw int32 dots order
    correctly within each window)."""
    n, d = x.shape
    if n % WINDOW:
        raise ValueError(f"N={n} must be a multiple of {WINDOW}")
    xb = x.reshape(n // WINDOW, WINDOW, d)
    absmax = np.abs(xb).max(axis=(1, 2))
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(xb / scale[:, None, None]), -127, 127).astype(np.int8)
    return q.reshape(n, d), scale


def quantize_block_rows_device(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor twin of ``quantize_block_rows`` (round half to even), with
    the scale computed as the reference's jitted twin does
    (``quantize.INV_127``)."""
    from qrag_tpu_torch.ops.quantize import INV_127

    n, d = x.shape
    xb = x.to(torch.float32).reshape(n // WINDOW, WINDOW, d)
    absmax = xb.abs().amax(dim=(1, 2))
    scale = torch.where(absmax > 0, absmax * INV_127, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(xb / scale[:, None, None]), -127, 127)
    return q.to(torch.int8).reshape(n, d), scale
