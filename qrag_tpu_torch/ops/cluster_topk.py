"""Cluster-pruned provably-exact top-k (PyTorch port of
``qrag_tpu.ops.cluster_topk``): the small-batch latency complement to
``ops.bounded_topk``.

At small batch the full scan is bound by reading the corpus, so the
latency lever is reading less of it.  The module doc of the reference
derives the design; in short:

  build (``build_clustered_groups``): k-means over the stored rows on
  the device, then a stable host sort of rows by (cluster, original
  index) into FIXED-SIZE groups of ``group_rows`` consecutive permuted
  rows, every cluster padded to a group boundary.  Per group: centroid,
  covering radius, max row norm (inflated for their own f32 rounding).

  search (``cluster_pruned_topk``): score the B queries against the G
  centroids, turn them into rigorous per-group goodness upper bounds
  (triangle inequality plus f32 evaluation margins), exactly score
  every row of the top-S groups (each group one contiguous (L, d)
  slice of ``corpus_p``), and certify: if at most S groups have a bound
  at or above the k-th exact score, no unread row can enter the top-k.
  A failed certificate escalates to 4S, then falls back to a chunked
  IEEE-f32 scan with original-index tie-break merging.

Where the reference branches with ``lax.cond`` on a certificate the
port reads ONE host flag per tier (the pattern of
``ops.bounded_topk._certify_escalate``), so a tier runs only when the
one before it failed.  Group selection is the port's stable ``top_k``:
among equal bounds the lower group id wins, as with ``lax.top_k``.

Result contract as ``bounded_exact_topk``: exact top-k goodness
(descending) of the refine-domain scoring function over the ORIGINAL
row indices, ties to the lower original index; padding rows score -inf
and carry ``_PAD_IDX``.  The products run in IEEE f32 (the package
refuses TF32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.ops.bounded_topk import (
    _SAFETY,
    _exact_scores,
    margin_coeff,
    topk_tiebreak,
)
from qrag_tpu_torch.ops.topk import top_k

# groups per fallback chunk: the build pads G to a multiple of this so
# the chunked exact fallback reshapes (N_pad, d) evenly
_FALLBACK_GROUP_CHUNK = 16
# rows per fallback matmul (a multiple of the chunk above): one launch
# per 64k rows instead of the reference's one scan step per chunk
_FALLBACK_ROWS = 1 << 16
# bytes of gathered group rows one scoring step copies at most
_GROUP_READ_BYTES = 1 << 30
# row sentinel of padding slots (the reference's 2^30)
_PAD_IDX = 1 << 30
# groups per step of the build's statistics (bounds its temporaries)
_STATS_GROUPS = 256


def _acc_rel(d: int) -> float:
    """Relative error bound of one f32 reduction over d terms.  The
    cluster bound compares fl-computed stats (qsq, csq, radii, sqnorms)
    against TRUE geometric quantities, so each one's own computation
    error is covered explicitly."""
    return max(d, 768) / 768.0 * 7.5e-5


class ClusteredGroups(NamedTuple):
    """Device-resident acceleration structure over a permuted corpus
    (the reference's fields).  ``sqnorms_p`` are the SCORING norms
    (possibly the caller's master f32 norms, ``norm_gap`` then widens
    the bounds by the per-group positive part of stored minus scoring
    norm)."""

    corpus_p: torch.Tensor  # (N_pad, d) store dtype
    sqnorms_p: torch.Tensor  # (N_pad,) f32 (the SCORING norms)
    orig_idx: torch.Tensor  # (N_pad,) int64 (pad rows: _PAD_IDX)
    valid_p: torch.Tensor  # (N_pad,) bool
    centroids: torch.Tensor  # (G, d) f32
    csq: torch.Tensor  # (G,) f32
    radii: torch.Tensor  # (G,) f32 (inflated for f32 rounding)
    maxnorms: torch.Tensor  # (G,) f32
    norm_gap: torch.Tensor  # (G,) f32 max(stored sq - scoring sq, 0)
    group_valid: torch.Tensor  # (G,) bool
    group_rows: int  # L


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def _assign_chunk(xb: torch.Tensor, c: torch.Tensor, csq: torch.Tensor) -> torch.Tensor:
    """l2 assignment of rows to centroids via the dot identity
    (argmax of x.c - |c|^2 / 2; ties to the lower centroid)."""
    return torch.argmax(xb @ c.T - 0.5 * csq[None, :], dim=1)


def _kmeans_assign(
    x32: torch.Tensor,  # (N, d) f32
    init: torch.Tensor,  # (n_clusters, d) f32
    n_clusters: int,
    iters: int,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means on the device, chunked over rows; the per-
    cluster sums are a one-hot product (deterministic, unlike atomic
    scatters).  Returns (centroids, assignment (N,) int64).  Quality
    sets the pruning rate, never exactness."""
    c = init
    for _ in range(iters):
        csq = torch.sum(c * c, dim=1)
        sums = torch.zeros_like(c)
        counts = torch.zeros((n_clusters,), dtype=torch.float32, device=c.device)
        for s in range(0, x32.shape[0], chunk):
            xb = x32[s : s + chunk]
            one = torch.nn.functional.one_hot(
                _assign_chunk(xb, c, csq), n_clusters
            ).to(torch.float32)
            sums = sums + one.T @ xb
            counts = counts + one.sum(dim=0)
        # empty clusters keep their previous centroid
        c = torch.where(
            counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), c
        )
    return c, _kmeans_assign_only(x32, c, chunk)


def _kmeans_assign_only(
    x32: torch.Tensor, cent: torch.Tensor, chunk: int
) -> torch.Tensor:
    """One chunked assignment pass of every row to its nearest
    centroid."""
    csq = torch.sum(cent * cent, dim=1)
    return torch.cat([
        _assign_chunk(x32[s : s + chunk], cent, csq)
        for s in range(0, x32.shape[0], chunk)
    ])


def cluster_assignments(
    corpus: Union[torch.Tensor, np.ndarray],  # (N, d)
    group_rows: int = 512,
    rows_per_cluster: int = 0,  # 0 = 4 * group_rows
    kmeans_iters: int = 6,
    seed: int = 0,
    chunk: int = 16384,
    device=None,
) -> np.ndarray:
    """The expensive half of the build: k-means cluster assignment of
    every row, (N,) int32 — what ``DeviceFlatIndex.save_native``
    persists.  The same seeded initial rows and training subsample as
    the reference; any assignment yields an exact structure."""
    corpus = _as_tensor(corpus, device)
    n, _ = corpus.shape
    x32 = corpus.to(torch.float32)
    # clusters several groups wide: ~L/2 pad rows per cluster -> ~12% at 4L
    rpc = rows_per_cluster or 4 * group_rows
    n_clusters = max(1, n // rpc)

    rng = np.random.default_rng(seed)
    init_rows = np.sort(rng.choice(n, size=n_clusters, replace=False))
    init = x32[torch.from_numpy(init_rows).to(corpus.device)]
    # Lloyd iterations train on a SUBSAMPLE; the full corpus gets one
    # assignment pass
    train_cap = max(131072, 64 * n_clusters)
    if n > train_cap:
        stride = -(-n // train_cap)
        x_train = x32[::stride]
    else:
        x_train = x32
    cent, _ = _kmeans_assign(
        x_train, init, n_clusters, kmeans_iters, min(chunk, x_train.shape[0])
    )
    assign = _kmeans_assign_only(x32, cent, min(chunk, n))
    return assign.to(torch.int32).cpu().numpy()


def _group_stats(cp: torch.Tensor, valid: torch.Tensor, g_pad: int, L: int):
    """Per-row sqnorms and per-group centroid, csq, inflated radius and
    max norm, validity — in steps of ``_STATS_GROUPS`` groups."""
    d = cp.shape[1]
    infl = 1.0 + _acc_rel(d)
    out = [[] for _ in range(6)]
    for g0 in range(0, g_pad, _STATS_GROUPS):
        g1 = min(g0 + _STATS_GROUPS, g_pad)
        x = cp[g0 * L : g1 * L].to(torch.float32)
        sq = torch.sum(x * x, dim=1)
        xg = x.reshape(g1 - g0, L, d)
        vg = valid[g0 * L : g1 * L].reshape(g1 - g0, L)
        cnt = torch.sum(vg, dim=1).to(torch.float32)
        cent = torch.sum(
            torch.where(vg[:, :, None], xg, 0.0), dim=1
        ) / torch.clamp_min(cnt[:, None], 1.0)
        diff = xg - cent[:, None, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=2))
        radii = torch.amax(torch.where(vg, dist, 0.0), dim=1)
        mxn = torch.sqrt(
            torch.amax(torch.where(vg, sq.reshape(g1 - g0, L), 0.0), dim=1)
        )
        # inflate for the f32 rounding of computing the stats themselves
        radii = radii * infl + 1e-20
        mxn = mxn * infl + 1e-20
        csq = torch.sum(cent * cent, dim=1)
        for part, value in zip(out, (sq, cent, csq, radii, mxn, cnt > 0)):
            part.append(value)
        del x, xg, diff
    return [torch.cat(part) for part in out]


def build_clustered_groups(
    corpus: Union[torch.Tensor, np.ndarray],  # (N, d) store dtype
    group_rows: int = 512,
    rows_per_cluster: int = 0,
    kmeans_iters: int = 6,
    seed: int = 0,
    chunk: int = 16384,
    assign: Optional[np.ndarray] = None,
    sqnorms: Optional[torch.Tensor] = None,  # (N,) f32 SCORING norms
    device=None,
) -> ClusteredGroups:
    """Build the acceleration structure on the corpus' device (a numpy
    corpus goes to ``device``).  A persisted ``assign`` (from
    ``cluster_assignments``) skips the k-means.  ``sqnorms`` = the
    index's master f32 row norms makes the accelerator score with the
    same refine function as the index's other l2 paths; the bounds then
    widen by the per-group ``norm_gap``.

    Layout invariant: every cluster is padded to a GROUP boundary, so
    no group spans two clusters."""
    corpus = _as_tensor(corpus, device)
    dev = corpus.device
    n, d = corpus.shape
    L = group_rows
    if sqnorms is not None and tuple(sqnorms.shape) != (n,):
        raise ValueError(f"sqnorms shape {tuple(sqnorms.shape)} does not match n={n}")
    if n == 0:
        return empty_groups(d, L, corpus.dtype, dev)
    if n < L and assign is None:
        # too few rows to cluster usefully: one sequential group
        assign = np.zeros((n,), np.int32)
    if assign is None:
        assign = cluster_assignments(
            corpus, group_rows=L, rows_per_cluster=rows_per_cluster,
            kmeans_iters=kmeans_iters, seed=seed, chunk=chunk,
        )
    else:
        assign = np.asarray(assign, np.int32)
        if assign.shape != (n,) or (n and (assign.min() < 0 or assign.max() >= n)):
            # the max bound also keeps a corrupted artifact from driving
            # np.bincount into a (max+1)-sized allocation
            raise ValueError(
                "persisted cluster assignment does not match the "
                f"corpus (shape {assign.shape} vs n={n}) — rebuild it"
            )

    # stable sort by (cluster, original index): equal-cluster rows keep
    # ascending original order (the reference's host permutation)
    order = np.lexsort((np.arange(n), assign)).astype(np.int64)
    sizes = np.bincount(assign)
    sizes = sizes[sizes > 0]  # empty clusters contribute no groups
    padded = (-(-sizes // L) * L).astype(np.int64)
    g_total = int(padded.sum()) // L
    g_pad = -(-g_total // _FALLBACK_GROUP_CHUNK) * _FALLBACK_GROUP_CHUNK
    n_pad = g_pad * L
    perm_p = np.zeros((n_pad,), np.int64)
    valid = np.zeros((n_pad,), bool)
    starts = np.concatenate([[0], np.cumsum(padded)])[:-1]
    src = 0
    for off, size in zip(starts, sizes):
        perm_p[off : off + size] = order[src : src + size]
        valid[off : off + size] = True
        src += size
    orig_idx = np.where(valid, perm_p, _PAD_IDX)

    perm_t = torch.from_numpy(perm_p).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)
    corpus_p = corpus.index_select(0, perm_t)
    corpus_p[~valid_t] = 0
    sq, cent, csq, radii, mxn, gvalid = _group_stats(corpus_p, valid_t, g_pad, L)
    sq = torch.where(valid_t, sq, 0.0)
    if sqnorms is None:
        # scoring norms == stored-row norms: no gap (their own f32 error
        # is covered by _group_upper_bounds' acc * (qsq + mxn^2) term)
        norm_gap = torch.zeros((g_pad,), dtype=torch.float32, device=dev)
    else:
        sq_m = torch.where(
            valid_t, sqnorms.to(dev, torch.float32).index_select(0, perm_t), 0.0
        )
        # positive part of (stored sq - scoring sq) per group; 1e-6
        # covers the subtraction's own rounding
        gap = torch.clamp_min(sq - sq_m, 0.0)
        gap = torch.amax(torch.where(valid_t, gap, 0.0).reshape(g_pad, L), dim=1)
        sq, norm_gap = sq_m, gap * (1.0 + 1e-6) + 1e-30
    return ClusteredGroups(
        corpus_p=corpus_p,
        sqnorms_p=sq,
        orig_idx=torch.from_numpy(orig_idx).to(dev),
        valid_p=valid_t,
        centroids=cent,
        csq=csq,
        radii=radii,
        maxnorms=mxn,
        norm_gap=norm_gap,
        group_valid=gvalid,
        group_rows=L,
    )


def empty_groups(d: int, group_rows: int, dtype, device=None) -> ClusteredGroups:
    """All-invalid structure for a rowless corpus: every group bound is
    -inf, every row invalid; it certifies trivially."""
    dev = resolve_device(device)
    L = group_rows
    g = _FALLBACK_GROUP_CHUNK
    n_pad = g * L
    f32 = dict(dtype=torch.float32, device=dev)
    return ClusteredGroups(
        corpus_p=torch.zeros((n_pad, d), dtype=dtype, device=dev),
        sqnorms_p=torch.zeros((n_pad,), **f32),
        orig_idx=torch.full((n_pad,), _PAD_IDX, dtype=torch.int64, device=dev),
        valid_p=torch.zeros((n_pad,), dtype=torch.bool, device=dev),
        centroids=torch.zeros((g, d), **f32),
        csq=torch.zeros((g,), **f32),
        radii=torch.zeros((g,), **f32),
        maxnorms=torch.zeros((g,), **f32),
        norm_gap=torch.zeros((g,), **f32),
        group_valid=torch.zeros((g,), dtype=torch.bool, device=dev),
        group_rows=L,
    )


def _group_upper_bounds(
    q32: torch.Tensor,  # (B, d)
    qsq: torch.Tensor,  # (B, 1)
    cg: ClusteredGroups,
    metric: str,
    d: int,
) -> torch.Tensor:
    """(B, G) rigorous goodness upper bound for ANY valid row of each
    group: triangle inequality over centroid and radius, plus margins
    for the f32 evaluation drift of the centroid dot and of the refine
    evaluation (the terms and their order are the reference's)."""
    qn = torch.sqrt(qsq)  # (B, 1)
    cn = torch.sqrt(cg.csq)[None, :]  # (1, G)
    qc = q32 @ cg.centroids.T  # (B, G) f32
    coeff = margin_coeff(torch.float32, torch.float32, torch.float32, d)
    acc = _acc_rel(d)
    e_qc = coeff * qn * cn  # |fl(q.c) - q.c| bound (safety included)
    mxn = cg.maxnorms[None, :]
    if metric == "l2":
        # refine g_r = 2 fl(q.x_r) - qsq_a - xsq_a <= (qsq_true - qsq_a)
        # + (xsq_true - xsq_a) - dist_lb^2 + 2 coeff |q| maxnorm, plus
        # the scoring-norm gap
        refine_m = (
            2.0 * coeff * qn * mxn + acc * (qsq + mxn * mxn)
            + cg.norm_gap[None, :] + 1e-30
        )
        d2 = qsq + cg.csq[None, :] - 2.0 * qc
        e2 = _SAFETY * (2.0 * e_qc + acc * (qsq + cg.csq[None, :]))
        d_lb = torch.sqrt(torch.clamp_min(d2 - e2, 0.0))
        dist_lb = torch.clamp_min(d_lb - cg.radii[None, :], 0.0)
        ub = -(dist_lb * dist_lb) + refine_m
    elif metric == "ip":
        # fl(q.x_r) <= fl(qc) + e_qc + |q| r + refine drift (radii and
        # maxnorms already inflated at build)
        refine_m = coeff * qn * mxn
        ub = qc + _SAFETY * e_qc + qn * cg.radii[None, :] + refine_m
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(cg.group_valid[None, :], ub, -torch.inf)


def _score_selected_groups(
    q32: torch.Tensor,  # (B, d)
    qsq: torch.Tensor,  # (B, 1)
    cg: ClusteredGroups,
    gsel: torch.Tensor,  # (B, S) group ids
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly score every row of the selected groups: ((B, S*L)
    goodness, (B, S*L) original indices).  Each group is one contiguous
    (L, d) slice of ``corpus_p.view(G, L, d)``, read by group id; the
    copy of a step is bounded by ``_GROUP_READ_BYTES``."""
    L = cg.group_rows
    n_pad, d = cg.corpus_p.shape
    g_count = n_pad // L
    b, S = gsel.shape
    rows_g = cg.corpus_p.view(g_count, L, d)
    sq_g = cg.sqnorms_p.view(g_count, L)
    oid_g = cg.orig_idx.view(g_count, L)
    vld_g = cg.valid_p.view(g_count, L)
    step = max(1, _GROUP_READ_BYTES // max(1, b * L * d * cg.corpus_p.element_size()))
    parts_g, parts_i = [], []
    for s0 in range(0, S, step):
        # (B*s,) group ids: one index_select of whole groups (the 2-D
        # advanced index takes a slower elementwise copy on CUDA)
        gs = gsel[:, s0 : s0 + step].reshape(-1)
        rows = rows_g.index_select(0, gs).view(b, -1, d)  # (B, s*L, d)
        gsc = _exact_scores(q32, rows, sq_g.index_select(0, gs).view(b, -1), qsq, metric)
        vld = vld_g.index_select(0, gs).view(b, -1)
        parts_g.append(torch.where(vld, gsc, -torch.inf))
        parts_i.append(torch.where(vld, oid_g.index_select(0, gs).view(b, -1), _PAD_IDX))
    return torch.cat(parts_g, dim=1), torch.cat(parts_i, dim=1)


def _certify_tier(q32, qsq, cg: ClusteredGroups, ub, k: int, S: int, metric: str):
    """One certification tier at budget S: select, exactly score,
    threshold, certify.  Returns (vals, idx, fail) with ``fail`` a
    0-dim bool tensor on the device."""
    S = min(S, ub.shape[1])
    _, gsel = top_k(ub, S)  # (B, S) exact stable selection
    cand_g, cand_i = _score_selected_groups(q32, qsq, cg, gsel, metric)
    vals, idx = topk_tiebreak(cand_g, cand_i, k)
    thr = vals[:, k - 1]
    # with EXACT top-S selection, count <= S implies coverage
    count = torch.sum(ub >= thr[:, None], dim=1)
    # a -inf threshold (fewer than k real rows read) voids the
    # certificate: the fallback handles tiny and padded corpora
    fail = torch.any(count > S) | torch.any(~torch.isfinite(thr))
    return vals, idx, fail


def _fallback_full(
    q32: torch.Tensor, qsq: torch.Tensor, cg: ClusteredGroups, k: int, metric: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unconditional-exactness backstop: chunked IEEE-f32 scan of the
    PERMUTED corpus, merged on (goodness, original index) by
    ``topk_tiebreak`` so ties follow the original order."""
    n_pad, _ = cg.corpus_p.shape
    b = q32.shape[0]
    base = _FALLBACK_GROUP_CHUNK * cg.group_rows
    ch = max(base, _FALLBACK_ROWS // base * base)
    cv = torch.full((b, k), -torch.inf, dtype=torch.float32, device=q32.device)
    ci = torch.full((b, k), _PAD_IDX, dtype=torch.int64, device=q32.device)
    for s in range(0, n_pad, ch):
        xb = cg.corpus_p[s : s + ch].to(torch.float32)
        dots = q32 @ xb.T
        sb = cg.sqnorms_p[s : s + ch]
        g = 2.0 * dots - qsq - sb[None, :] if metric == "l2" else dots
        vb = cg.valid_p[s : s + ch][None, :]
        g = torch.where(vb, g, -torch.inf)
        oid = torch.where(vb, cg.orig_idx[s : s + ch][None, :], _PAD_IDX).expand(b, -1)
        cv, ci = topk_tiebreak(torch.cat([cv, g], dim=1), torch.cat([ci, oid], dim=1), k)
    return cv, ci


def _query_terms(queries, cg: ClusteredGroups):
    q32 = _as_tensor(queries, cg.corpus_p.device).to(cg.corpus_p.device, torch.float32)
    return q32, torch.sum(q32 * q32, dim=1, keepdim=True)


def _cluster_probe_topk(q32, qsq, cg: ClusteredGroups, k: int, metric: str, budget: int):
    """IVF-style PROBE search: score the top-S groups, no certificates
    (FAISS-IVF nprobe semantics, S == nprobe in group units).  Scores
    of returned hits are exact refine-domain evaluations."""
    ub = _group_upper_bounds(q32, qsq, cg, metric, q32.shape[1])
    S = min(max(budget, k), ub.shape[1])
    _, gsel = top_k(ub, S)
    cand_g, cand_i = _score_selected_groups(q32, qsq, cg, gsel, metric)
    return topk_tiebreak(cand_g, cand_i, k)


def _cluster_pruned_topk(q32, qsq, cg: ClusteredGroups, k: int, metric: str, budget: int):
    """The certified ladder: tier 1 at S, tier 2 at 4S, then the chunked
    fallback; one host read of the failure flag per tier.  Returns
    (vals, idx, fell_back, escalated) with Python bool flags."""
    ub = _group_upper_bounds(q32, qsq, cg, metric, q32.shape[1])
    g_count = ub.shape[1]
    S1 = min(max(budget, k), g_count)
    v1, i1, f1 = _certify_tier(q32, qsq, cg, ub, k, S1, metric)
    # a structure with NO valid rows trivially certifies: its all--inf
    # result IS exact (no phantom fallbacks)
    f1 = bool(f1 & torch.any(cg.valid_p))
    S2 = min(4 * S1, g_count)
    if S2 <= S1:
        # the budget covers every group: only a degenerate threshold can
        # fail, which the fallback handles; the escalated flag mirrors
        # the fallback so a fallback is always preceded by a tier-1 failure
        if f1:
            v1, i1 = _fallback_full(q32, qsq, cg, k, metric)
        return v1, i1, f1, f1
    if not f1:
        return v1, i1, False, False
    v2, i2, f2 = _certify_tier(q32, qsq, cg, ub, k, S2, metric)
    if bool(f2):
        v2, i2 = _fallback_full(q32, qsq, cg, k, metric)
        return v2, i2, True, True
    return v2, i2, False, True


def cluster_pruned_topk(
    queries,  # (B, d) float (cast to f32 — exact)
    groups: ClusteredGroups,
    k: int,
    metric: str = "l2",
    budget: Optional[int] = None,
    certify: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, bool, bool]:
    """Provably-exact top-k over the clustered structure (module doc).

    Returns (goodness desc (B, k), ORIGINAL indices (B, k) int64,
    fell_back (the chunked exact scan ran), escalated (tier 1 failed)).
    ``certify=False`` is the IVF nprobe mode: the same selection and
    exact candidate scoring, no certificates; both flags False."""
    if budget is None:
        budget = _auto_budget(k, groups.group_rows)
    q32, qsq = _query_terms(queries, groups)
    if not certify:
        vals, idx = _cluster_probe_topk(q32, qsq, groups, k, metric, budget)
        return vals, idx, False, False
    return _cluster_pruned_topk(q32, qsq, groups, k, metric, budget)


def _auto_budget(k: int, group_rows: int) -> int:
    """Default group budget S: every top-k row in a distinct group with
    a 2x headroom notch, floored at 8.  Corpora whose geometry defeats
    the bound self-correct through escalation and fallback."""
    del group_rows
    return max(8, 2 * k)
