"""QragEngine — retrieval + fused rerank (PyTorch port of
``qrag_tpu.engine``).

One object owns the device-resident index, the embedder and the
rerankers.  The fused path runs retrieval top-C -> gather of the
candidates' cached rotation features -> analytic fidelity -> top-k on
the device, with no host round trip between the stages; with
``use_analytic_fidelity=False`` it scores the candidates' raw rows by
the full complex statevector instead.  The routed
path ("auto" and "classical") gathers the candidates' raw rows with the
row-gather kernel (``ops.gather_rows``) and selects per query between
the fidelity and the cosine expert.

``quantization="int8"`` builds the ``QuantizedFlatIndex`` (row or
window scan, exact or gather-free scores); its fused reranks take their
candidates from the store matrix in the index's "approx" mode (the
fused scan + top-k kernel, ``ops.topk``), as the reference does.
``bounded_scan="int8"`` runs the bounded scan, and the fused rerank's
candidate generation, on int8 codes.  With ``small_batch_accel`` set,
small batches of ``search_rerank`` take their candidates from the
index's clustered accelerator (``ops.cluster_topk``).

``index.sharded`` builds the row-sharded index over a mesh of slots
(``parallel.sharded_index``; ``index.elastic`` wraps it in
``parallel.elastic``), and ``search_rerank`` takes its sharded arm.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qrag_tpu_torch.config import QragConfig
from qrag_tpu_torch.documents import Document
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex, SearchResult
from qrag_tpu_torch.index.quantized_index import QuantizedFlatIndex
from qrag_tpu_torch.ops import topk as topk_ops
from qrag_tpu_torch.ops.topk import _finalize, flat_scan_topk, top_k
from qrag_tpu_torch.pipeline.embeddings import Embedder, get_embedder
from qrag_tpu_torch.reranker.controller import RerankerController
from qrag_tpu_torch.utils.metrics import GLOBAL_METRICS, Metrics

logger = logging.getLogger(__name__)

def _fused_candidates(
    query_vecs: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    valid_rows: torch.Tensor,
    candidates: int,
    metric: str,
    topk_mode: str,
    bounded_bufs=None,
    bounded_query_store: bool = False,
    bounded_kind: str = "bf16",
    cluster_groups=None,
    cluster_budget: int = 16,
    cluster_probe: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finalized (B, C) retrieval scores + indices for the fused rerank:
    the cluster-pruned search when ``topk_mode="clustered"`` and
    ``cluster_groups`` (the index's built structure) are given (exact;
    ``cluster_probe`` selects its IVF arm; invalid slots carry
    ``_PAD_IDX``), the provably-exact bounded scan when ``bounded_bufs``
    (the index's bounded buffers: the bf16 scan copy, or the int8 codes
    and margin inputs per ``bounded_kind``) are given, else the exact
    sort."""
    if topk_mode == "clustered" and cluster_groups is not None:
        from qrag_tpu_torch.ops.cluster_topk import cluster_pruned_topk

        vals, idx, _, _ = cluster_pruned_topk(
            query_vecs, cluster_groups, candidates, metric=metric,
            budget=cluster_budget, certify=not cluster_probe,
        )
        return _finalize(vals, idx, metric)
    if topk_mode == "bounded" and bounded_bufs is not None:
        from qrag_tpu_torch.ops.bounded_topk import (
            bounded_exact_topk,
            bounded_exact_topk_int8,
        )

        # the margin regime keys off the query DTYPE: rounded queries
        # stay in the store dtype (zero query-rounding error)
        q = (
            query_vecs.to(corpus.dtype)
            if bounded_query_store
            else query_vecs.to(torch.float32)
        )
        if bounded_kind == "int8":
            q8x, wscale, mx, minsq, resid, lr = bounded_bufs
            vals, idx, _, _, _ = bounded_exact_topk_int8(
                q.to(torch.float32), q8x, wscale, corpus, corpus_sqnorms,
                mx, minsq, resid, lr, candidates,
                metric=metric, valid_rows=valid_rows,
            )
        else:
            scan, maxnorms, lane_rank = bounded_bufs
            vals, idx, _, _, _ = bounded_exact_topk(
                q, scan, corpus, corpus_sqnorms, maxnorms, lane_rank,
                candidates, metric=metric, valid_rows=valid_rows,
            )
        return _finalize(vals, idx, metric)
    # "verified" has a host patch-up stage: the fused candidates take
    # its approx pass (the rerank re-scores the set either way), with no
    # oversampling of their own
    return flat_scan_topk(
        query_vecs.to(corpus.dtype), corpus, candidates, metric=metric,
        corpus_sqnorms=corpus_sqnorms, valid_rows=valid_rows,
        mode="approx" if topk_mode in ("verified", "bounded", "clustered") else topk_mode,
        oversample=1,
    )


# amplitudes (complex64) one step of the full-statevector rerank holds
_STATEVECTOR_STEP = 1 << 25


def _statevector_fidelity(
    query_vecs: torch.Tensor, cand: torch.Tensor, n_qubits: int
) -> torch.Tensor:
    """(B, d) queries x (B, C, d) candidate rows -> (B, C) fidelities by
    the full statevector, in query steps of at most
    ``_STATEVECTOR_STEP`` candidate amplitudes."""
    from qrag_tpu_torch.ops.statevector import fidelity_statevector

    b, c = cand.shape[:2]
    step = max(1, _STATEVECTOR_STEP // (c * 2 ** n_qubits))
    return torch.cat([
        fidelity_statevector(query_vecs[s : s + step, None, :], cand[s : s + step], n_qubits)
        for s in range(0, b, step)
    ])


def fused_search_rerank(
    query_vecs: torch.Tensor,  # (B, d)
    corpus: torch.Tensor,  # (N, d)
    corpus_sqnorms: torch.Tensor,  # (N,)
    valid_rows: torch.Tensor,  # (N,) bool
    k: int,
    candidates: int,
    n_qubits: int,
    fid_feats: Optional[torch.Tensor] = None,  # (N, n_qubits) cached features
    metric: str = "l2",
    topk_mode: str = "exact",
    analytic: bool = True,
    **candidate_kw,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Retrieval top-C -> quantum fidelity -> top-k.  The analytic path
    gathers the candidates' cached rotation features (``fid_feats``);
    ``analytic=False`` scores their raw rows by the full statevector.
    ``candidate_kw`` selects the candidate stage (``_fused_candidates``).

    Returns (fidelity (B, k) desc, corpus indices (B, k), retrieval
    scores of the selected rows (B, k))."""
    from qrag_tpu_torch.ops.statevector import (
        fidelity_from_features,
        rotation_features,
    )

    retr_scores, idx = _fused_candidates(
        query_vecs, corpus, corpus_sqnorms, valid_rows, candidates, metric,
        topk_mode, **candidate_kw,
    )  # (B, C)
    # invalid slots (C > ntotal) are masked below; they gather row 0, as
    # a pad slot's _PAD_IDX would lie past the cache
    invalid = (
        torch.isinf(retr_scores) if metric == "l2" else torch.isneginf(retr_scores)
    )
    rows = torch.where(invalid, 0, idx)
    if analytic:
        q_feat = rotation_features(query_vecs.to(torch.float32), n_qubits)
        fid = fidelity_from_features(q_feat, fid_feats[rows])  # (B, C)
    else:
        fid = _statevector_fidelity(query_vecs, corpus[rows], n_qubits)
    fid = torch.where(invalid, -torch.inf, fid)
    top_fid, sel = top_k(fid, k)
    return top_fid, idx.gather(1, sel), retr_scores.gather(1, sel)


def fused_search_rerank_routed(
    query_vecs: torch.Tensor,  # (B, d)
    route_quantum: torch.Tensor,  # (B,) bool — True: fidelity expert
    corpus: torch.Tensor,  # (N, d)
    corpus_sqnorms: torch.Tensor,  # (N,)
    valid_rows: torch.Tensor,  # (N,) bool
    k: int,
    candidates: int,
    n_qubits: int,
    metric: str = "l2",
    topk_mode: str = "exact",
    **candidate_kw,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query expert-routed rerank: both experts score the gathered
    (B, C, d) candidate rows — the analytic fidelity on the raw rows and
    the cosine — and ``route_quantum`` picks per row.  ``candidate_kw``
    selects the candidate stage (``_fused_candidates``).

    Returns (scores (B, k) desc, corpus indices (B, k), retrieval
    scores of the selected rows (B, k))."""
    from qrag_tpu_torch.ops.gather_rows import gather_rows_2d
    from qrag_tpu_torch.ops.statevector import fidelity_analytic

    retr_scores, idx = _fused_candidates(
        query_vecs, corpus, corpus_sqnorms, valid_rows, candidates, metric,
        topk_mode, **candidate_kw,
    )  # (B, C)
    # invalid slots (C > ntotal) carry out-of-range indices: the kernel
    # clamps them, and the rows they fetch are masked below
    cand = gather_rows_2d(corpus, idx).to(torch.float32)  # (B, C, d)
    q32 = query_vecs.to(torch.float32)
    fid = fidelity_analytic(q32[:, None, :], cand, n_qubits)  # expert 1
    qn = q32 / torch.linalg.norm(q32, dim=-1, keepdim=True).clamp_min(1e-12)
    cn = cand / torch.linalg.norm(cand, dim=-1, keepdim=True).clamp_min(1e-12)
    cos = torch.einsum("bd,bcd->bc", qn, cn)  # expert 2
    scores = torch.where(route_quantum[:, None], fid, cos)
    invalid = (
        torch.isinf(retr_scores) if metric == "l2" else torch.isneginf(retr_scores)
    )
    scores = torch.where(invalid, -torch.inf, scores)
    top, sel = top_k(scores, k)
    return top, idx.gather(1, sel), retr_scores.gather(1, sel)


def _index_cls_and_kwargs(config: QragConfig):
    """Single source of truth for building an index from config.  The
    sharded family lays its mesh (``config.mesh``) on the device the
    caller passes."""
    if config.index.sharded:
        from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex

        mode = config.index.topk_mode
        if mode == "refined":
            # the sharded scan has no host-side candidate re-score
            # stage; the downgrade is loud (stats show the mode)
            logger.warning(
                "sharded index does not support topk_mode='refined'; "
                "serving with 'approx' (per-shard candidate selection + "
                "exact merge) — use 'verified'/'bounded'/'exact' for "
                "exact sharded results",
            )
            mode = "approx"
        kw = dict(
            topk_mode=mode,
            store_dtype=config.index.dtype,
            merge=config.index.shard_merge,
            bounded_query_dtype=config.index.bounded_query_dtype,
            small_batch_accel=config.index.small_batch_accel,
            accel_max_batch=config.index.accel_max_batch,
            cluster_group_rows=config.index.cluster_group_rows,
            cluster_budget=config.index.cluster_budget or None,
            accel_read_cap=config.index.accel_read_cap,
            mesh_config=config.mesh,
        )
        if config.index.elastic:
            from qrag_tpu_torch.parallel.elastic import ElasticShardedIndex

            # elastic owns its slot set (re-sharding shrinks it)
            return ElasticShardedIndex, kw
        return ShardedFlatIndex, kw
    kw = dict(
        row_pad_multiple=config.index.row_pad_multiple,
        use_pallas=config.index.use_pallas,
        topk_mode=config.index.topk_mode,
        store_dtype=config.index.dtype,
        bounded_scan=config.index.bounded_scan,
        bounded_query_dtype=config.index.bounded_query_dtype,
        small_batch_accel=config.index.small_batch_accel,
        accel_max_batch=config.index.accel_max_batch,
        cluster_group_rows=config.index.cluster_group_rows,
        cluster_budget=config.index.cluster_budget or None,
        accel_read_cap=config.index.accel_read_cap,
    )
    if config.index.quantization == "int8":
        kw["refine_factor"] = config.index.refine_factor
        kw["scan"] = config.index.quant_scan
        kw["exact_scores"] = config.index.exact_scores
        return QuantizedFlatIndex, kw
    return DeviceFlatIndex, kw


class QragEngine:
    """Owns index + embedder + rerankers; serves search and rerank."""

    def __init__(
        self,
        config: Optional[QragConfig] = None,
        index: Optional[DeviceFlatIndex] = None,
        embedder: Optional[Embedder] = None,
        controller: Optional[RerankerController] = None,
        metrics: Optional[Metrics] = None,
        device=None,
    ):
        self.config = config or QragConfig()
        if index is None:
            cls_, kw = _index_cls_and_kwargs(self.config)
            index = cls_(
                d=self.config.embedding.dim,
                metric=self.config.index.metric,
                normalize=self.config.index.normalize,
                device=device,
                **kw,
            )
        self.index = index
        self.device = index.device
        self.embedder = embedder or get_embedder(self.config.embedding, self.device)
        self.controller = controller or RerankerController(
            self.config, device=self.device
        )
        self.metrics = metrics or GLOBAL_METRICS

    # ------------------------------------------------------------- index ops

    @classmethod
    def from_faiss(
        cls, path: str, config: Optional[QragConfig] = None, device=None,
        **kwargs,
    ) -> "QragEngine":
        config = config or QragConfig()
        cls_, kw = _index_cls_and_kwargs(config)
        index = cls_.load_faiss(path, device=device, **kw)
        return cls(config=config, index=index, **kwargs)

    def add_texts(
        self, texts: Sequence[str], metadata: Optional[Sequence[str]] = None
    ) -> int:
        """Embed + normalize + add."""
        return self.index.add(self.embedder(list(texts)), metadata)

    # ------------------------------------------------------------ query path

    def search(
        self, queries: Union[str, Sequence[str], np.ndarray], k: int = 10
    ) -> SearchResult:
        """Exact top-k retrieval; text queries are embedded first."""
        with self.metrics.timer("search"):
            if isinstance(queries, str):
                qv = self.embedder([queries])
            elif isinstance(queries, (list, tuple)):
                qv = self.embedder(list(queries))
            else:
                qv = np.asarray(queries, dtype=np.float32)
            result = self.index.search(qv, k=k)
        self.metrics.incr("search_requests")
        return result

    def rerank(
        self,
        query: str,
        documents: List[Document],
        top_k: Optional[int] = None,
        reranker_type: str = "auto",
    ) -> Dict[str, Any]:
        """The reference's ``POST /rerank``: route, then rerank the
        given documents."""
        with self.metrics.timer("rerank"):
            out = self.controller.rerank(query, documents, top_k, reranker_type)
        self.metrics.incr("rerank_requests")
        self.metrics.incr(f"rerank_{out['reranker_used']}")
        return out

    def search_rerank(
        self,
        queries: Union[str, Sequence[str], np.ndarray],
        k: int = 10,
        candidates: int = 100,
        reranker_type: str = "quantum",
    ) -> Dict[str, Any]:
        """Fused retrieval -> rerank over the device corpus: retrieves
        ``candidates`` nearest rows, returns the top ``k`` by fidelity
        ("quantum"), cosine ("classical"), or the expert the controller
        routes each text query to ("auto"; vectors without text rerank
        by fidelity and say so)."""
        if reranker_type not in ("auto", "quantum", "classical", "none", "retrieval"):
            raise ValueError(
                f"unknown reranker_type {reranker_type!r}; expected "
                "'auto', 'quantum', 'classical', or 'none'"
            )
        with self.metrics.timer("search_rerank"):
            query_texts: Optional[List[str]] = None
            if isinstance(queries, str):
                query_texts = [queries]
            elif isinstance(queries, (list, tuple)):
                query_texts = [str(q) for q in queries]
            if query_texts is not None:
                qv = self.embedder(query_texts)
            else:
                qv = np.asarray(queries, dtype=np.float32)
            if qv.ndim == 1:
                qv = qv[None, :]
            n = self.index.ntotal
            if n == 0:
                return {"queries": qv.shape[0], "results": [], "reranker_used": reranker_type}
            c_eff = min(candidates, n)
            k_eff = min(k, c_eff)
            if not self.index.has_device_snapshot:
                # sharded index: per-shard scan + exact merge + the
                # candidates' rows gathered across shards
                return self._search_rerank_sharded(
                    qv, query_texts, n, k_eff, c_eff, reranker_type
                )
            q = torch.from_numpy(np.ascontiguousarray(qv)).to(self.device)
            if reranker_type == "auto" and query_texts is None:
                # no text: the routing truth table cannot run
                reranker_type = "quantum"
            if reranker_type in ("none", "retrieval"):
                retr_t, idx = self.index.search_device(q, k_eff)
                scores, indices = retr_t.cpu().numpy(), idx.cpu().numpy()
                retr_scores = scores
                reranker_type = "none"  # honest label: no rerank ran
            else:
                snap = self.index.device_buffers()  # one atomic generation
                if reranker_type == "quantum":
                    fid, idx, retr = self._fused_quantum(
                        q, k_eff, c_eff, snap, batch=qv.shape[0]
                    )
                else:
                    # "classical": the routed graph with an all-cosine mask
                    route = [False] * qv.shape[0]
                    if reranker_type == "auto":
                        route = [
                            self.controller.select_reranker(t) == "quantum"
                            for t in query_texts
                        ]
                    fused_mode, bounded_kw = self._fused_candidate_mode(
                        c_eff, snap, batch=qv.shape[0]
                    )
                    fid, idx, retr = fused_search_rerank_routed(
                        q, torch.tensor(route, device=self.device),
                        snap.matrix, snap.sqnorms, snap.valid,
                        k=k_eff, candidates=c_eff,
                        n_qubits=self.config.quantum.n_qubits,
                        metric=self.index.metric, topk_mode=fused_mode,
                        **bounded_kw,
                    )
                scores, indices = fid.cpu().numpy(), idx.cpu().numpy()
                retr_scores = retr.cpu().numpy()
            results = self._build_hits(scores, indices, retr_scores, n)
        self.metrics.incr("search_rerank_requests")
        return {
            "queries": indices.shape[0],
            "results": results,
            "reranker_used": reranker_type,
        }

    def _fused_quantum(
        self, q: torch.Tensor, k: int, candidates: int, snap, batch=None
    ):
        """The fused quantum rerank of device queries ``q`` over one
        snapshot: (fidelity, indices, retrieval scores) on the device.
        ``batch`` (the request's query count) lets a small batch take
        the clustered accelerator's candidates."""
        fused_mode, bounded_kw = self._fused_candidate_mode(candidates, snap, batch=batch)
        n_qubits = self.config.quantum.n_qubits
        analytic = bool(self.config.quantum.use_analytic_fidelity)
        return fused_search_rerank(
            q, snap.matrix, snap.sqnorms, snap.valid,
            k=k, candidates=candidates, n_qubits=n_qubits,
            fid_feats=self.index.fidelity_features(n_qubits, snap) if analytic else None,
            metric=self.index.metric, topk_mode=fused_mode, analytic=analytic,
            **bounded_kw,
        )

    def search_rerank_pipelined(
        self,
        queries: Union[Sequence[str], np.ndarray],
        k: int = 10,
        candidates: int = 100,
        micro_batch: int = 32,
        reranker_type: str = "quantum",
    ) -> Dict[str, Any]:
        """The quantum ``search_rerank`` in query micro-batches on one
        stream: every micro-batch's work is enqueued before the first
        result is copied to the host, so host-side result assembly
        overlaps the device.  Results equal ``search_rerank(...,
        reranker_type="quantum")`` on the concatenated batch."""
        if reranker_type != "quantum":
            raise ValueError(
                "search_rerank_pipelined implements the quantum rerank "
                "stage only; use search_rerank for "
                f"reranker_type={reranker_type!r}"
            )
        if isinstance(queries, str):
            queries = [queries]
        if isinstance(queries, (list, tuple)):
            qv = self.embedder([str(q) for q in queries])
        else:
            qv = np.asarray(queries, dtype=np.float32)
        if qv.ndim == 1:
            qv = qv[None, :]
        n = self.index.ntotal
        if n == 0:
            return {"queries": qv.shape[0], "results": [], "reranker_used": reranker_type}
        if not self.index.has_device_snapshot:
            raise ValueError(
                "search_rerank_pipelined needs a single-device index; use "
                "search_rerank on a sharded one"
            )
        c_eff = min(candidates, n)
        k_eff = min(k, c_eff)
        snap = self.index.device_buffers()  # one generation for every stage
        q = torch.from_numpy(np.ascontiguousarray(qv)).to(self.device)
        in_flight = [
            self._fused_quantum(q[i : i + micro_batch], k_eff, c_eff, snap)
            for i in range(0, q.shape[0], micro_batch)
        ]
        results = []
        for fid, idx, retr in in_flight:  # fetch in order
            results.extend(
                self._build_hits(
                    fid.cpu().numpy(), idx.cpu().numpy(), retr.cpu().numpy(), n
                )
            )
        self.metrics.incr("search_rerank_pipelined_requests")
        return {"queries": qv.shape[0], "results": results, "reranker_used": reranker_type}

    def sample_recall(self, k: int = 10, samples: int = 16, seed: int = 0) -> float:
        """Observability self-check: perturb random corpus rows slightly
        and measure the fraction whose source row lands in the top-k."""
        n = self.index.ntotal
        if n == 0:
            return 0.0
        rng = np.random.RandomState(seed)
        rows = rng.choice(n, size=min(samples, n), replace=False)
        base = self.index.sample_rows(rows)
        noise = 1e-3 * rng.randn(*base.shape).astype(np.float32)
        res = self.index.search(base + noise, k=min(k, n))
        hits = sum(1 for qi, row in enumerate(rows) if row in set(res.indices[qi]))
        self.metrics.incr("recall_samples", len(rows))
        return hits / len(rows)

    def _fused_candidate_mode(self, candidates: int, snap, batch=None):
        """Effective candidate-generation mode of the fused path and the
        kwargs that realize it.  With ``batch`` (the non-pipelined
        ``search_rerank``) an eligible small batch takes the clustered
        accelerator, built here against the CALLER's snapshot (a newer
        generation's structure could name rows the older matrix holds
        as capacity padding).  Otherwise "bounded" runs for real when
        the index shapes are eligible, else the exact sort."""
        if batch is not None and self.index._accel_eligible(batch, candidates):
            from qrag_tpu_torch.ops.cluster_topk import _auto_budget

            groups = self.index.build_clustered(snap=snap)
            return "clustered", {
                "cluster_groups": groups,
                "cluster_budget": self.index.cluster_budget
                or _auto_budget(candidates, groups.group_rows),
                "cluster_probe": self.index.small_batch_accel == "clustered_probe",
            }
        mode = self.index.topk_mode
        if mode == "bounded":
            if not self.index._bounded_eligible(candidates):
                return "exact", {}
            # the bufs must derive from the snapshot the graph gathers from
            kind = self.index.bounded_scan
            if kind == "int8":
                snap, bufs = self.index._bounded_buffers_int8(snap=snap)
            else:
                snap, bufs = self.index._bounded_buffers(snap=snap)
            return "bounded", {
                "bounded_bufs": bufs,
                "bounded_query_store": self.index.bounded_query_dtype == "store",
                "bounded_kind": kind,
            }
        if mode == "verified":
            # its host patch-up stage cannot run between the fused stages;
            # the rerank re-scores the approx set (``effective_topk_modes``)
            return "approx", {}
        return mode, {}

    def _search_rerank_sharded(
        self,
        qv: np.ndarray,
        query_texts: Optional[List[str]],
        n: int,
        k_eff: int,
        c_eff: int,
        reranker_type: str,
    ) -> Dict[str, Any]:
        """The sharded index's arm of ``search_rerank``: the same
        response and routing, the index's per-shard scan, merge and
        cross-shard row gather.  Its retrieval scores come finalized."""
        index = self.index
        n_qubits = self.config.quantum.n_qubits
        # the batch splits over the mesh's data axis: pad it to a multiple
        b = qv.shape[0]
        bp = -(-b // index._dp) * index._dp
        if bp != b:
            qv = np.pad(qv, ((0, bp - b), (0, 0)))
        q = torch.from_numpy(np.ascontiguousarray(qv, np.float32)).to(index.device)
        if reranker_type == "auto" and query_texts is None:
            reranker_type = "quantum"
        if reranker_type in ("auto", "classical"):
            route = np.zeros((bp,), dtype=bool)
            if reranker_type == "auto":
                route[:b] = [
                    self.controller.select_reranker(t) == "quantum" for t in query_texts
                ]
            fid, idx, retr = index.search_rerank_routed_device(
                q, torch.from_numpy(route), k_eff, c_eff, n_qubits
            )
        elif reranker_type == "quantum":
            fid, idx, retr = index.search_rerank_device(q, k_eff, c_eff, n_qubits)
        else:  # "none" / "retrieval"
            fid, idx = index.search_device(q, k_eff)
            retr = fid  # finalized retrieval scores, as the unsharded arm
            reranker_type = "none"
        results = self._build_hits(
            fid.cpu().numpy()[:b], idx.cpu().numpy()[:b], retr.cpu().numpy()[:b], n
        )
        self.metrics.incr("search_rerank_requests")
        return {"queries": b, "results": results, "reranker_used": reranker_type}

    def _build_hits(
        self,
        scores: np.ndarray,
        indices: np.ndarray,
        retr_scores: np.ndarray,
        n: int,
    ) -> List[List[Dict[str, Any]]]:
        """Response assembly: drop invalid/out-of-range slots, resolve
        metadata."""
        results = []
        for qi in range(indices.shape[0]):
            hits = []
            for j in range(indices.shape[1]):
                i = int(indices[qi, j])
                if i < 0 or i >= n or not np.isfinite(scores[qi, j]):
                    continue
                hits.append(
                    {
                        "index": i,
                        "score": float(scores[qi, j]),
                        "retrieval_score": float(retr_scores[qi, j]),
                        "metadata": self.index.metadata[i] or None,
                    }
                )
            results.append(hits)
        return results

    # ------------------------------------------------------------- lifecycle

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> float:
        """Run the serving shapes once (on CUDA this builds the kernels
        and the derived buffers before the first live query).  Returns
        seconds spent."""
        t0 = time.time()
        n = self.index.ntotal
        if n == 0:
            return 0.0
        if batch_sizes is None:
            batch_sizes = self.config.serving.warmup_batch_buckets
        k = min(10, n)  # /search and /search_rerank serving default
        candidates = min(100, n)  # /search_rerank serving default
        # the clustered accelerator's k-means is seconds at 1M rows: build
        # it here, not on the first live small batch (k=1 is the loosest
        # gate, so a corpus eligible at any serving k builds)
        if self.index.small_batch_accel != "none" and self.index._accel_eligible(1, 1):
            self.index.build_clustered()
        for b in batch_sizes:
            q = np.zeros((b, self.index.d), dtype=np.float32)
            self.index.search(q, k=k)
            self.search_rerank(q, k=min(k, candidates), candidates=candidates)
        # the doc-list rerank's device ops: the batcher's pair function
        # and the single-request scorer of the configured encoding
        qr = self.controller.quantum_reranker
        if qr is not None and qr.config.method == "state_fidelity":
            from qrag_tpu_torch.ops.statevector import amplitude_fidelity, batched_fidelity
            from qrag_tpu_torch.serving.batcher import _pair_fidelity_fn

            dim = np.asarray(qr.embedder(["warmup"])).shape[1]
            docs = torch.zeros((8, dim), dtype=torch.float32, device=qr.device)
            analytic = bool(qr.config.use_analytic_fidelity)
            _pair_fidelity_fn(qr.n_qubits, analytic, qr.config.encoding)(docs, docs).cpu()
            if qr.config.encoding == "amplitude":
                amplitude_fidelity(docs[0], docs, qr.n_qubits).cpu()
            else:
                batched_fidelity(docs[0], docs, n_qubits=qr.n_qubits, analytic=analytic).cpu()
        dt = time.time() - t0
        logger.info("engine warmup in %.2fs (batch buckets %s)", dt, tuple(batch_sizes))
        return dt

    def save(self, directory: str) -> None:
        """Persist the index (native manifest format) + the config tree:
        the reference's engine bundle, readable by both packages."""
        os.makedirs(directory, exist_ok=True)
        self.index.save_native(os.path.join(directory, "index"))
        with open(os.path.join(directory, "engine.json"), "w") as f:
            json.dump(
                {"format": "qrag_tpu.engine", "config": self.config.to_dict()},
                f,
                indent=2,
            )

    @classmethod
    def load(cls, directory: str, device=None, **kwargs) -> "QragEngine":
        with open(os.path.join(directory, "engine.json")) as f:
            meta = json.load(f)
        if meta.get("format") != "qrag_tpu.engine":
            raise ValueError(f"{directory}: not a qrag_tpu engine bundle")
        config = QragConfig.from_dict(meta["config"]).with_env_overrides()
        cls_, kw = _index_cls_and_kwargs(config)
        kw.pop("row_pad_multiple", None)  # the index manifest records it
        index = cls_.load_native(
            os.path.join(directory, "index"), device=device, **kw
        )
        return cls(config=config, index=index, **kwargs)

    def _effective_topk_modes(self) -> Dict[str, str]:
        """The mode each query path actually runs with."""
        idx = self.index
        mode = idx.topk_mode
        if not idx.has_device_snapshot:
            # sharded family: search == fused candidates == the per-shard
            # mode ("verified" and "bounded" run for real)
            return {"search": mode, "fused_candidates": mode, "pipelined_stage1": mode}
        fused = mode
        if mode == "verified":
            fused = "approx"
        elif mode == "bounded":
            c = min(100, max(idx.ntotal, 1))  # serving default budget
            # name-only: an observability call never triggers an upload
            rpm = idx.row_pad_multiple
            cap = (
                idx._snapshot.matrix.shape[0]
                if idx._snapshot is not None
                else max(rpm, -(-idx.ntotal // rpm) * rpm)
            )
            eligible = cap >= 4096 and cap % 128 == 0 and cap // 128 >= max(c, 16)
            fused = "bounded" if eligible and idx.ntotal else "exact"
        return {"search": mode, "fused_candidates": fused, "pipelined_stage1": fused}

    def stats(self) -> Dict[str, Any]:
        dev = self.device
        if dev.type == "cuda":
            devices = [
                f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())
            ]
        else:
            devices = [str(dev)]
        index_stats = {
            "ntotal": self.index.ntotal,
            "d": self.index.d,
            "metric": self.index.metric,
            "topk_mode": self.index.topk_mode,
            "verified_fallback_rows": self.index.fallback_rows,
            "bounded_escalations": self.index.bounded_escalations,
            # the clustered accelerator's ladder: escalation = the 4x
            # tier ran, fallback = the chunked full scan ran
            "small_batch_accel": self.index.small_batch_accel,
            "cluster_escalations": self.index.cluster_escalations,
            "cluster_fallbacks": self.index.cluster_fallbacks,
            "effective_topk_modes": self._effective_topk_modes(),
            # candidate selections of the approx / verified / refined
            # modes by route: the fused scan + top-k kernel, or the f32
            # product + sort past its k limit
            "selection_routes": dict(topk_ops.selection_routes),
        }
        if hasattr(self.index, "layout"):
            index_stats["layout"] = self.index.layout()
        return {
            "index": index_stats,
            "backend": dev.type,
            "devices": devices,
            "metrics": self.metrics.snapshot(),
        }
