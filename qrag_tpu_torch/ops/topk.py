"""Flat-index scan + top-k (PyTorch port of ``qrag_tpu.ops.topk``).

Both metrics reduce to a descending "goodness" selection: L2 goodness
is -d^2 = 2 q.x - |q|^2 - |x|^2, finalized to distances only at the API
edge (``_finalize``).

Every f32 product here runs in IEEE fp32: on Hopper a TF32 matmul keeps
~3 decimal digits, the same class of error as the TPU's DEFAULT-
precision f32 dot that the reference pins to HIGHEST.  The package
import refuses to load with TF32 matmuls enabled (``qrag_tpu_torch``).

Ties go to the LOWER index everywhere (``lax.top_k`` parity), which
``torch.topk`` does not promise: selection sorts stably instead.

Modes (the reference's names and contracts):

  * "exact"    — the full (B, N) goodness and a stable sort.
  * "approx"   — k x oversample candidates, then the exact f32
                 re-score of the candidates (``ops.quantize``) and the
                 top-k of those.  Scores of returned rows are exact.
  * "verified" — approx plus a per-row exactness certificate against
                 the whole corpus; rows that fail it are re-run with
                 the exact sort (``scan_topk_verified``, host patch-up).
  * "refined"  — approx with bf16 selection traffic: the candidates are
                 chosen on bf16-rounded operands, then re-scored in f32.
  * "bounded"  — the provably-exact window scan (``ops.bounded_topk``),
                 reached through the index; here it is the exact sort.

Selection.  The reference picks candidates with ``lax.approx_max_k``
over the (B, N) goodness; torch has no such partial reduce.  Here the
candidates come from the fused scan + top-k (``ops.scan_topk``: the
Hopper kernel on a CUDA tensor, its plain twin on a CPU tensor), so the
(B, N) matrix is never built.  That selection is EXACT in its own
evaluation of the goodness, with ties to the lower index: recall is at
least the reference's target, and ``recall_target`` has nothing left to
tune (it is kept for the reference's signatures).  The kernel takes
k <= ``MAX_K``; a wider candidate set (``scan_topk_verified_jit`` at
k = 100 asks for 1,600) takes the one other route, the kernel's plain
twin — the f32 product and a stable sort, in query chunks — on the
same device.  ``selection_routes`` counts each route; ``/stats`` shows
it.

The verified certificate.  The reference counts, over the (B, N)
goodness of the scan that selected the candidates, the rows strictly
better than the k-th returned value (at most k-1 for an exact set).
Here the selection is the kernel's, so the count runs over a second
pass of the exact sort's own evaluation of the goodness (``_goodness``,
a chunk of queries at a time, the (B, N) matrix never whole): with v
the weakest returned value in that evaluation and i the highest
returned row holding it, a row of the batch is ok when exactly k rows
of the corpus beat v or hold it at a row <= i.  The returned rows are
k of those, so they are then the exact top-k, ties to the lower index
included; a selection that missed a row of the top-k, or kept a higher
index among equal values, fails.  The returned values are that
evaluation's, as the exact sort's are.  The pass reads the corpus once
more: verified costs approx plus one f32 product over the corpus, as
the reference's second pass over its goodness does.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_OVERSAMPLE = 2
DEFAULT_RECALL_TARGET = 0.99
# below this corpus size the sort-based exact top-k is already cheap
APPROX_MIN_ROWS = 4096
# queries per (chunk, N) goodness matrix of the chunked exact sort
_EXACT_CHUNK = 128

# candidate selections by route: "scan_topk" (the fused scan + top-k
# kernel, or its twin on the CPU) and "product_sort" (k x oversample
# past the kernel's MAX_K: the f32 product and a stable sort)
selection_routes = {"scan_topk": 0, "product_sort": 0}
_routes_lock = threading.Lock()

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
    and the product runs in IEEE fp32.  A non-f32 corpus is upcast a
    block of rows at a time (``ops.scan_topk.f32_blocks``)."""
    from qrag_tpu_torch.ops.scan_topk import f32_blocks

    q32 = queries.to(torch.float32)
    if corpus.dtype == torch.float32:
        dots = q32 @ corpus.T
    else:
        dots = torch.empty(
            (q32.shape[0], corpus.shape[0]), dtype=torch.float32, device=q32.device
        )
        for s, x in f32_blocks(corpus):
            dots[:, s : s + x.shape[0]] = q32 @ x.T
            del x  # one block alive at a time
    if metric == "l2":
        if corpus_sqnorms is None:
            corpus_sqnorms = torch.cat(
                [torch.sum(x * x, dim=-1) for _, x in f32_blocks(corpus)]
            )
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
    g: torch.Tensor,
    k: int,
    mode: str = "exact",
    oversample: int = DEFAULT_OVERSAMPLE,
    recall_target: float = DEFAULT_RECALL_TARGET,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (descending, lower-index ties) of a goodness matrix.
    Returns (vals, idx).  "approx"/"verified" take k x oversample
    candidates and re-rank them; over a given matrix the candidate
    pick is the exact sort, so the result equals "exact"'s (as the
    reference's ``approx_max_k`` does on the CPU)."""
    del recall_target  # the selection is exact
    n = g.shape[-1]
    if mode == "exact" or n < APPROX_MIN_ROWS or k * oversample * 8 >= n:
        return top_k(g, k)
    if mode in ("approx", "verified"):
        sv, si = top_k(g, min(k * oversample, n))
        rv, ri = top_k(sv, k)  # re-rank of the candidates
        return rv, si.gather(-1, ri)
    raise ValueError(f"unknown topk mode {mode!r}")


def _exactness_deficit(g: torch.Tensor, kth_vals: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row certificate: #\\{g > v_k\\} must be <= k-1 for the
    result's *values* to be exact.  Returns a (B,) bool "row ok"."""
    return torch.sum(g > kth_vals[:, None], dim=1) <= k - 1


def _certify(queries, corpus, corpus_sqnorms, valid_rows, idx, k, metric, patch):
    """The verified certificate (module doc) of the returned rows ``idx``
    (B, k) against the whole corpus, a chunk of queries at a time.
    Returns (goodness, idx, row ok): the returned rows in ``_goodness``'s
    order with its values, or with ``patch`` a failing row's exact sort
    from the same chunk of goodness (no third pass)."""
    vs, is_, oks = [], [], []
    col = torch.arange(corpus.shape[0], device=queries.device)
    for s in range(0, queries.shape[0], _EXACT_CHUNK):
        g = _goodness(
            queries[s : s + _EXACT_CHUNK], corpus, metric, corpus_sqnorms, valid_rows
        )
        # the returned rows in id order (row -1: an empty slot), then by
        # value: a stable sort leaves equal values in id order
        ic = torch.sort(idx[s : s + _EXACT_CHUNK], dim=1).values
        got = torch.where(ic >= 0, g.gather(1, ic.clamp_min(0)), -torch.inf)
        got, p = torch.sort(got, dim=1, descending=True, stable=True)
        ic = ic.gather(1, p)
        thr = got[:, -1:]
        fin = torch.isfinite(thr[:, 0])
        max_in = torch.amax(torch.where(got == thr, ic, -1), dim=1, keepdim=True)
        max_in = torch.where(fin[:, None], max_in, -1)
        held = torch.sum(g > thr, dim=1) + torch.sum((g == thr) & (col <= max_in), dim=1)
        # fewer finite rows than k: every finite row must be returned
        ok = held == torch.where(fin, k, torch.sum(got > -torch.inf, dim=1))
        if patch and not bool(ok.all()):
            bad = ~ok
            ev, ei = top_k(g[bad], k)
            got, ic = got.clone(), ic.clone()
            got[bad], ic[bad] = ev, ei
        vs.append(got)
        is_.append(ic)
        oks.append(ok)
    return torch.cat(vs), torch.cat(is_), torch.cat(oks)


def _select(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    kk: int,
    metric: str,
    corpus_sqnorms: Optional[torch.Tensor],
    valid_rows: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kk best rows per query without the (B, N) matrix: raw
    goodness (B, kk) descending (-inf for slots past the valid rows)
    and int64 row ids (-1 there).  kk <= MAX_K: the fused scan + top-k;
    past it: the f32 product and a stable sort (the kernel's plain
    twin), in query chunks."""
    from qrag_tpu_torch.ops import scan_topk as st

    if kk <= st.MAX_K:
        route = "scan_topk"
        vals, idx = st.scan_goodness_topk(
            queries, corpus, kk, metric, corpus_sqnorms, valid_rows, compute_dtype
        )
    else:
        route = "product_sort"
        vals, idx = st._blocked_topk(
            queries, corpus, kk, metric, corpus_sqnorms, valid_rows, compute_dtype,
            st.plain_goodness_topk,
        )
    with _routes_lock:
        selection_routes[route] += 1
    vals = torch.where(vals <= st.NEG / 2, -torch.inf, vals)
    return vals, idx.to(torch.int64)


def _select_and_rescore(
    queries, corpus, corpus_sqnorms, valid_rows, k, kk, metric, compute_dtype
):
    """Selection of kk candidates, their exact f32 re-score and its
    top-k: (goodness (B, k), idx (B, k))."""
    from qrag_tpu_torch.ops.quantize import refine_candidates

    sv, si = _select(
        queries, corpus, kk, metric, corpus_sqnorms, valid_rows, compute_dtype
    )
    return refine_candidates(queries, corpus, si, sv, k, metric, corpus_sqnorms)


def _scan_topk_device(
    queries,
    corpus,
    corpus_sqnorms,
    valid_rows,
    k: int,
    metric: str,
    mode: str,
    oversample: int,
    recall_target: float,
):
    """Raw (goodness, idx, row ok) of one mode; "ok" is the verified
    certificate (all True for the other modes)."""
    del recall_target  # the selection is exact
    b, n = queries.shape[0], corpus.shape[0]
    ones = torch.ones((b,), dtype=torch.bool, device=queries.device)
    if mode == "refined":
        # bf16 selection traffic (the kernel's bf16 arm rounds the
        # operands; the reference rounds the f32 goodness), then the
        # exact re-score of the gathered candidates
        kk = min(max(k * max(oversample, 2), k), n)
        vals, idx = _select_and_rescore(
            queries, corpus, corpus_sqnorms, valid_rows, k, kk, metric,
            torch.bfloat16,
        )
        return vals, idx, ones
    if mode not in ("exact", "approx", "verified"):
        raise ValueError(f"unknown topk mode {mode!r}")
    if mode == "exact" or n < APPROX_MIN_ROWS or k * oversample * 8 >= n:
        g = _goodness(queries, corpus, metric, corpus_sqnorms, valid_rows)
        vals, idx = top_k(g, k)
        ok = _exactness_deficit(g, vals[:, -1], k) if mode == "verified" else ones
        return vals, idx, ok
    vals, idx = _select_and_rescore(
        queries, corpus, corpus_sqnorms, valid_rows, k, min(k * oversample, n),
        metric, torch.float32,
    )
    if mode == "verified":
        return _certify(
            queries, corpus, corpus_sqnorms, valid_rows, idx, k, metric, patch=False
        )
    return vals, idx, ones


def _finalize(vals: torch.Tensor, idx: torch.Tensor, metric: str):
    if metric == "l2":
        dist = torch.where(
            torch.isneginf(vals), torch.inf, torch.clamp_min(-vals, 0.0)
        )
        return dist, idx
    return vals, idx


def ip_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    valid_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inner-product top-k: (scores desc, indices), (B, k) each.
    The f32 product and a stable sort, as the reference's ``_goodness``
    + ``lax.top_k`` (no kernel: neither runs through Pallas)."""
    return top_k(_goodness(queries, corpus, "ip", None, valid_rows), k)


def l2_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    corpus_sqnorms: Optional[torch.Tensor] = None,
    valid_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact squared-L2 top-k, FAISS semantics: (distances ascending,
    indices), +inf where a row is masked."""
    g = _goodness(queries, corpus, "l2", corpus_sqnorms, valid_rows)
    return _finalize(*top_k(g, k), "l2")


def flat_scan_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[torch.Tensor] = None,
    valid_rows: Optional[torch.Tensor] = None,
    mode: str = "exact",
    oversample: int = DEFAULT_OVERSAMPLE,
    recall_target: float = DEFAULT_RECALL_TARGET,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, indices): distances ascending for "l2", inner products
    descending for "ip".  No host sync: "verified" behaves as "approx"
    here (its patch-up lives in ``scan_topk_verified`` and
    ``DeviceFlatIndex.search``).  "bounded" reaching this generic
    dispatch (ineligible shapes) is the exact sort — both are exact,
    this one is just the sort."""
    if mode == "bounded":
        mode = "exact"
    vals, idx, _ = _scan_topk_device(
        queries, corpus, corpus_sqnorms, valid_rows, k, metric,
        "approx" if mode == "verified" else mode, oversample, recall_target,
    )
    return _finalize(vals, idx, metric)


def scan_topk_verified_jit(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[torch.Tensor] = None,
    valid_rows: Optional[torch.Tensor] = None,
    oversample: int = 16,
    recall_target: float = DEFAULT_RECALL_TARGET,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verified-exact top-k that returns device tensors: a deep
    (oversample x k) candidate selection, the certificate, and the
    exact sort of the rows that fail it, from the certificate's own
    goodness.  Returns (finalized scores, indices, n_fallback_rows
    as a 0-dim tensor)."""
    del recall_target
    vals, idx, n_bad = _verified_topk(
        queries, corpus, corpus_sqnorms, valid_rows, k, metric, oversample
    )
    fin_vals, fin_idx = _finalize(vals, idx, metric)
    return fin_vals, fin_idx, n_bad


def _verified_topk(queries, corpus, corpus_sqnorms, valid_rows, k, metric, oversample):
    """``scan_topk_verified_jit`` before finalizing: raw (goodness, idx,
    n_bad); the per-shard verified search of the sharded index."""
    kk = min(max(oversample * k, k), corpus.shape[0])
    _, idx = _select_and_rescore(
        queries, corpus, corpus_sqnorms, valid_rows, k, kk, metric, torch.float32
    )
    vals, idx, ok = _certify(
        queries, corpus, corpus_sqnorms, valid_rows, idx, k, metric, patch=True
    )
    return vals, idx, torch.sum(~ok)


def scan_topk_verified(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[torch.Tensor] = None,
    valid_rows: Optional[torch.Tensor] = None,
    oversample: int = DEFAULT_OVERSAMPLE,
    recall_target: float = DEFAULT_RECALL_TARGET,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-level verified-exact scan: approx pass + certificate +
    exact re-run of only the failing rows, patched into a writable
    copy.  Returns numpy (scores, indices, n_fallback_rows)."""
    vals, idx, ok = _scan_topk_device(
        queries, corpus, corpus_sqnorms, valid_rows, k, metric, "verified",
        oversample, recall_target,
    )
    ok_np = ok.cpu().numpy()
    vals_np = vals.cpu().numpy().copy()
    idx_np = idx.cpu().numpy().copy()
    n_bad = int((~ok_np).sum())
    if n_bad:
        bad_rows = np.nonzero(~ok_np)[0]
        fix_vals, fix_idx, _ = _scan_topk_device(
            queries[torch.from_numpy(bad_rows).to(queries.device)], corpus,
            corpus_sqnorms, valid_rows, k, metric, "exact", oversample,
            recall_target,
        )
        vals_np[bad_rows] = fix_vals.cpu().numpy()
        idx_np[bad_rows] = fix_idx.cpu().numpy()
    s, i = _finalize(torch.from_numpy(vals_np), torch.from_numpy(idx_np), metric)
    return s.numpy(), i.numpy(), n_bad
