"""QragEngine — retrieval + fused quantum-fidelity rerank (PyTorch port
of ``qrag_tpu.engine``).

One object owns the device-resident index and the embedder.  The fused
path runs retrieval top-C -> gather of the candidates' cached rotation
features -> analytic fidelity -> top-k on the device, with no host
round trip between the stages.

Not ported yet (raise NotImplementedError, ROADMAP.md Queue 1 slice 2):
the "auto" and "classical" rerankers and their controller, ``rerank``
(document-list rerank), ``search_rerank_pipelined``, the routed fused
graph and the sharded index; the full-statevector fidelity
(``use_analytic_fidelity=False``, slice 7); int8 quantization (slice 5).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qrag_tpu.config import QragConfig
from qrag_tpu.pipeline.embeddings import Embedder, get_embedder
from qrag_tpu.utils.metrics import GLOBAL_METRICS, Metrics
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex, SearchResult
from qrag_tpu_torch.ops.topk import _finalize, flat_scan_topk, top_k

logger = logging.getLogger(__name__)

_SLICE2 = "(ROADMAP.md, Queue 1 slice 2)"


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finalized (B, C) retrieval scores + indices for the fused rerank:
    the provably-exact bounded scan when ``bounded_bufs`` (the index's
    bf16 scan copy, window max norms, lane ranks) are given, else the
    exact sort."""
    if topk_mode == "bounded" and bounded_bufs is not None:
        from qrag_tpu_torch.ops.bounded_topk import bounded_exact_topk

        scan, maxnorms, lane_rank = bounded_bufs
        # the margin regime keys off the query DTYPE: rounded queries
        # stay in the store dtype (zero query-rounding error)
        q = (
            query_vecs.to(corpus.dtype)
            if bounded_query_store
            else query_vecs.to(torch.float32)
        )
        vals, idx, _, _, _ = bounded_exact_topk(
            q, scan, corpus, corpus_sqnorms, maxnorms, lane_rank,
            candidates, metric=metric, valid_rows=valid_rows,
        )
        return _finalize(vals, idx, metric)
    return flat_scan_topk(
        query_vecs.to(corpus.dtype), corpus, candidates, metric=metric,
        corpus_sqnorms=corpus_sqnorms, valid_rows=valid_rows, mode=topk_mode,
    )


def fused_search_rerank(
    query_vecs: torch.Tensor,  # (B, d)
    corpus: torch.Tensor,  # (N, d)
    corpus_sqnorms: torch.Tensor,  # (N,)
    valid_rows: torch.Tensor,  # (N,) bool
    k: int,
    candidates: int,
    n_qubits: int,
    fid_feats: torch.Tensor,  # (N, n_qubits) cached rotation features
    metric: str = "l2",
    topk_mode: str = "exact",
    bounded_bufs=None,
    bounded_query_store: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Retrieval top-C -> analytic quantum fidelity -> top-k.

    Returns (fidelity (B, k) desc, corpus indices (B, k), retrieval
    scores of the selected rows (B, k))."""
    from qrag_tpu_torch.ops.statevector import (
        fidelity_from_features,
        rotation_features,
    )

    retr_scores, idx = _fused_candidates(
        query_vecs, corpus, corpus_sqnorms, valid_rows, candidates, metric,
        topk_mode, bounded_bufs, bounded_query_store,
    )  # (B, C)
    q_feat = rotation_features(query_vecs.to(torch.float32), n_qubits)
    fid = fidelity_from_features(q_feat, fid_feats[idx])  # (B, C)
    # mask invalid candidate slots (C > ntotal)
    invalid = (
        torch.isinf(retr_scores) if metric == "l2" else torch.isneginf(retr_scores)
    )
    fid = torch.where(invalid, -torch.inf, fid)
    top_fid, sel = top_k(fid, k)
    return top_fid, idx.gather(1, sel), retr_scores.gather(1, sel)


def _index_cls_and_kwargs(config: QragConfig):
    """Single source of truth for building an index from config
    (single device, no quantization)."""
    if config.index.sharded:
        raise NotImplementedError(
            "the sharded index is not ported yet (ROADMAP.md, Queue 1 slice 6)"
        )
    if config.index.quantization != "none":
        raise NotImplementedError(
            "int8 quantization is not ported yet (ROADMAP.md, Queue 1 slice 5)"
        )
    kw = dict(
        row_pad_multiple=config.index.row_pad_multiple,
        use_pallas=config.index.use_pallas,
        topk_mode=config.index.topk_mode,
        store_dtype=config.index.dtype,
        bounded_scan=config.index.bounded_scan,
        bounded_query_dtype=config.index.bounded_query_dtype,
        small_batch_accel=config.index.small_batch_accel,
    )
    return DeviceFlatIndex, kw


def _embedder(config: QragConfig) -> Embedder:
    if config.embedding.provider == "trained":
        raise NotImplementedError(
            "the trained bi-encoder embedder is not ported yet (ROADMAP.md, "
            "Queue 1 slice 3); use provider 'hash' or 'mock'"
        )
    return get_embedder(config.embedding)


class QragEngine:
    """Owns index + embedder; serves search and the fused rerank."""

    def __init__(
        self,
        config: Optional[QragConfig] = None,
        index: Optional[DeviceFlatIndex] = None,
        embedder: Optional[Embedder] = None,
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
        self.embedder = embedder or _embedder(self.config)
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

    def rerank(self, *args, **kwargs):
        raise NotImplementedError(f"document-list rerank is not ported yet {_SLICE2}")

    def search_rerank_pipelined(self, *args, **kwargs):
        raise NotImplementedError(
            f"search_rerank_pipelined is not ported yet {_SLICE2}"
        )

    def search_rerank(
        self,
        queries: Union[str, Sequence[str], np.ndarray],
        k: int = 10,
        candidates: int = 100,
        reranker_type: str = "quantum",
    ) -> Dict[str, Any]:
        """Fused retrieval -> quantum-fidelity rerank over the device
        corpus: retrieves ``candidates`` nearest rows, returns the top
        ``k`` by fidelity."""
        if reranker_type in ("auto", "classical"):
            raise NotImplementedError(
                f"reranker_type {reranker_type!r} is not ported yet {_SLICE2}"
            )
        if reranker_type not in ("quantum", "none", "retrieval"):
            raise ValueError(
                f"unknown reranker_type {reranker_type!r}; expected "
                "'auto', 'quantum', 'classical', or 'none'"
            )
        with self.metrics.timer("search_rerank"):
            if isinstance(queries, str):
                qv = self.embedder([queries])
            elif isinstance(queries, (list, tuple)):
                qv = self.embedder([str(q) for q in queries])
            else:
                qv = np.asarray(queries, dtype=np.float32)
            if qv.ndim == 1:
                qv = qv[None, :]
            n = self.index.ntotal
            if n == 0:
                return {"queries": qv.shape[0], "results": [], "reranker_used": reranker_type}
            c_eff = min(candidates, n)
            k_eff = min(k, c_eff)
            q = torch.from_numpy(np.ascontiguousarray(qv)).to(self.device)
            if reranker_type == "quantum":
                if not self.config.quantum.use_analytic_fidelity:
                    raise NotImplementedError(
                        "the full-statevector fidelity is not ported yet "
                        "(ROADMAP.md, Queue 1 slice 7)"
                    )
                snap = self.index.device_buffers()  # one atomic generation
                fused_mode, bounded_kw = self._fused_candidate_mode(c_eff, snap)
                n_qubits = self.config.quantum.n_qubits
                fid, idx, retr = fused_search_rerank(
                    q, snap.matrix, snap.sqnorms, snap.valid,
                    k=k_eff, candidates=c_eff, n_qubits=n_qubits,
                    fid_feats=self.index.fidelity_features(n_qubits, snap),
                    metric=self.index.metric, topk_mode=fused_mode,
                    **bounded_kw,
                )
                scores, indices = fid.cpu().numpy(), idx.cpu().numpy()
                retr_scores = retr.cpu().numpy()
            else:
                retr_t, idx = self.index.search_device(q, k_eff)
                scores, indices = retr_t.cpu().numpy(), idx.cpu().numpy()
                retr_scores = scores
                reranker_type = "none"  # honest label: no rerank ran
            results = self._build_hits(scores, indices, retr_scores, n)
        self.metrics.incr("search_rerank_requests")
        return {
            "queries": indices.shape[0],
            "results": results,
            "reranker_used": reranker_type,
        }

    def _fused_candidate_mode(self, candidates: int, snap):
        """Effective candidate-generation mode of the fused path and the
        kwargs that realize it: "bounded" runs for real when the index
        shapes are eligible, otherwise the exact sort."""
        if self.index.topk_mode == "bounded" and self.index._bounded_eligible(
            candidates
        ):
            # the bufs must derive from the snapshot the graph gathers from
            snap, bufs = self.index._bounded_buffers(snap=snap)
            return "bounded", {
                "bounded_bufs": bufs,
                "bounded_query_store": self.index.bounded_query_dtype == "store",
            }
        return "exact", {}

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
        for b in batch_sizes:
            q = np.zeros((b, self.index.d), dtype=np.float32)
            self.index.search(q, k=k)
            self.search_rerank(q, k=min(k, candidates), candidates=candidates)
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
        fused = mode
        if mode == "bounded":
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
        return {"search": mode, "fused_candidates": fused}

    def stats(self) -> Dict[str, Any]:
        dev = self.device
        if dev.type == "cuda":
            devices = [
                f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())
            ]
        else:
            devices = [str(dev)]
        return {
            "index": {
                "ntotal": self.index.ntotal,
                "d": self.index.d,
                "metric": self.index.metric,
                "topk_mode": self.index.topk_mode,
                "verified_fallback_rows": self.index.fallback_rows,
                "bounded_escalations": self.index.bounded_escalations,
                "effective_topk_modes": self._effective_topk_modes(),
            },
            "backend": dev.type,
            "devices": devices,
            "metrics": self.metrics.snapshot(),
        }
