"""Dynamic request batching for serving (PyTorch port of
``qrag_tpu.serving.batcher``).

Concurrent HTTP requests each carry a handful of queries, but the
device scan amortizes with batch size.  The batcher aggregates queries
from concurrent requests into one device call: callers enqueue
(vectors, k) and block on a future; a worker thread drains the queue,
runs ONE engine call on the combined batch, and scatters the results
back.  Every result is on the host before its future resolves.

``max_wait_s`` bounds the added latency (default 2 ms); ``max_batch``
bounds the queries of one device call and ``max_pairs`` the (query,
document) pairs of one coalesced document rerank.  Requests with
different k are served with max(k) and trimmed per caller.  (The
reference also pads every batch to a power of two so that XLA reuses
compiled shapes; PyTorch compiles nothing per shape, and the exact
results do not depend on the batch, so the port does not pad.)

Requests carry an integer ``priority`` (default 0): when the queue is
backlogged, higher-priority requests go first, equal priorities stay
FIFO.  Effective priority ages with queue wait (+1 per
``priority_aging_s`` waited, applied at drain time), so sustained
high-priority traffic cannot starve default-priority requests.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from qrag_tpu_torch.documents import validate_documents
from qrag_tpu_torch.index.flat_index import SearchResult
from qrag_tpu_torch.ops.statevector import amplitude_encode, batched_fidelity


@dataclass
class _Pending:
    vectors: Optional[np.ndarray]  # (n, d); None for doc-list reranks
    k: int
    future: Future = field(default_factory=Future)
    params: tuple = ()  # extra grouping key (rerank candidates/type)
    payload: Any = None  # (query, documents, top_k) for doc-list reranks
    priority: int = 0  # higher serves first when the queue is backlogged


def _pair_fidelity_fn(n_qubits: int, analytic: bool, encoding: str):
    """The PAIR-flattened fidelity of one quantum config: ``(P, dim)``
    query rows x ``(P, dim)`` doc rows -> ``(P,)`` tensor, one score per
    pair — the device op behind coalesced /rerank requests."""
    if encoding == "amplitude":
        def pair(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
            inner = torch.sum(
                torch.real(amplitude_encode(q, n_qubits))
                * torch.real(amplitude_encode(d, n_qubits)),
                dim=-1,
            )
            return inner * inner
    else:
        def pair(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
            return batched_fidelity(q, d, n_qubits=n_qubits, analytic=analytic)

    return pair


class SearchBatcher:
    """Aggregates concurrent search calls into single device batches.

    Plain searches batch freely (k differences are served with max(k)
    and trimmed); fused search+rerank requests batch among requests
    with identical (k, candidates, reranker_type)."""

    def __init__(
        self,
        engine,
        max_wait_s: float = 0.002,
        max_batch: int = 64,
        max_pairs: int = 512,
        priority_aging_s: float = 0.25,
    ):
        self.engine = engine
        self.max_wait_s = max_wait_s
        self.max_batch = max_batch
        self.max_pairs = max_pairs
        self.priority_aging_s = max(priority_aging_s, 1e-6)
        # drained by effective (aged) priority; FIFO within ties via seq
        self._items: List[Tuple[int, int, float, _Pending]] = []
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._stop = threading.Event()
        self.batches = 0
        self.batched_queries = 0
        self.prioritized_served = 0  # requests served with priority > 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client

    def _submit(self, item: _Pending):
        with self._cv:
            # checked inside the critical section: a submitter passing an
            # outside check while close() drains could block forever
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            self._items.append((int(item.priority), next(self._seq), time.time(), item))
            self._cv.notify()
        return item.future.result()

    def search(self, vectors: np.ndarray, k: int = 10, priority: int = 0):
        """Blocking search through the batcher; returns SearchResult."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        return self._submit(_Pending(vectors=vectors, k=k, priority=priority))

    def search_rerank(
        self,
        vectors: np.ndarray,
        k: int = 10,
        candidates: int = 100,
        reranker_type: str = "quantum",
        priority: int = 0,
    ) -> dict:
        """Blocking fused search+rerank through the batcher; returns the
        engine's result dict for THESE vectors only."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        return self._submit(
            _Pending(
                vectors=vectors,
                k=k,
                params=("rerank", k, candidates, reranker_type),
                priority=priority,
            )
        )

    def rerank_documents(
        self,
        query: str,
        documents: list,
        top_k: Optional[int] = None,
        reranker_type: str = "auto",
        priority: int = 0,
    ) -> dict:
        """Blocking document-list rerank (``POST /rerank``) through the
        batcher.  Routing resolves on the host first; quantum requests
        flatten their (query, doc) pairs into one device fidelity call,
        classical ones keep the single-request path (its score cache and
        neutral degradation are per-request state).  Returns the
        controller-shaped result dict."""
        expert = (
            self.engine.controller.select_reranker(query)
            if reranker_type == "auto"
            else reranker_type
        )
        return self._submit(
            _Pending(
                vectors=None,
                k=top_k if top_k is not None else -1,
                params=("docrr", expert),
                payload=(query, documents, top_k),
                priority=priority,
            )
        )

    def close(self) -> None:
        """Stop the worker and FAIL any still-pending requests so no
        caller blocks forever on a dead queue."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._worker.join(timeout=5)
        with self._cv:
            pending, self._items = self._items, []
        for _, _, _, item in pending:
            if not item.future.done():
                item.future.set_exception(RuntimeError("batcher closed"))

    def stats(self) -> dict:
        return {
            "batches": self.batches,
            "batched_queries": self.batched_queries,
            "mean_batch": (
                round(self.batched_queries / self.batches, 2) if self.batches else 0.0
            ),
            "prioritized_served": self.prioritized_served,
        }

    # ------------------------------------------------------------- worker

    def _pop_best_locked(self) -> _Pending:
        """Pop the item with the highest effective priority (nominal +
        age / priority_aging_s), FIFO within ties.  Caller holds the
        lock."""
        now = time.time()
        best = min(
            range(len(self._items)),
            key=lambda i: (
                -(self._items[i][0] + (now - self._items[i][2]) / self.priority_aging_s),
                self._items[i][1],
            ),
        )
        return self._items.pop(best)[3]

    def _drain(self) -> List[_Pending]:
        def size(it: _Pending) -> int:
            if it.vectors is not None:
                return it.vectors.shape[0]
            return max(1, len(it.payload[1]))  # doc-list rerank

        with self._cv:
            if not self._items:
                self._cv.wait(timeout=0.05)
            if not self._items:
                return []
            items = [self._pop_best_locked()]
        total = size(items[0])
        deadline = time.time() + self.max_wait_s
        while total < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            with self._cv:
                if not self._items and not self._cv.wait(timeout=remaining):
                    break
                if not self._items:
                    continue
                nxt = self._pop_best_locked()
            items.append(nxt)
            total += size(nxt)
        self.prioritized_served += sum(1 for it in items if it.priority > 0)
        return items

    def _run(self) -> None:
        while not self._stop.is_set():
            items = self._drain()
            # only identical-parameter requests share a device call
            groups: dict = {}
            for it in items:
                groups.setdefault(it.params, []).append(it)
            for group in groups.values():
                try:
                    self._serve(group)
                except Exception as e:  # noqa: BLE001 - per-request
                    for it in group:
                        if not it.future.done():
                            it.future.set_exception(e)

    def _serve(self, items: List[_Pending]) -> None:
        kind = items[0].params[0] if items[0].params else "search"
        if kind == "docrr":
            self._serve_doc_rerank(items)
        elif kind == "rerank":
            self._serve_rerank(items)
        else:
            self._serve_search(items)

    def _serve_search(self, items: List[_Pending]) -> None:
        vecs = np.concatenate([it.vectors for it in items], axis=0)
        k = max(it.k for it in items)
        res = self.engine.search(vecs, k=k)
        self.batches += 1
        self.batched_queries += vecs.shape[0]
        off = 0
        for it in items:
            sl = slice(off, off + it.vectors.shape[0])
            it.future.set_result(
                SearchResult(
                    scores=res.scores[sl][:, : it.k],
                    indices=res.indices[sl][:, : it.k],
                    metadata=[row[: it.k] for row in res.metadata[sl]],
                )
            )
            off += it.vectors.shape[0]

    def _serve_doc_rerank(self, items: List[_Pending]) -> None:
        _, expert = items[0].params
        controller = self.engine.controller
        if expert != "quantum":
            # classical: per-request path (cache/neutral semantics)
            for it in items:
                query, documents, top_k = it.payload
                it.future.set_result(
                    controller.rerank(query, documents, top_k, reranker_type=expert)
                )
            return
        qr = controller.quantum_reranker
        # requests that fail validation (or are empty) keep the fallback
        # contract through the single-request path
        coalesced: List[_Pending] = []
        for it in items:
            query, documents, top_k = it.payload
            if (
                not documents
                or not validate_documents(query, documents)
                or qr.config.method != "state_fidelity"
            ):
                it.future.set_result(
                    controller.rerank(query, documents, top_k, reranker_type="quantum")
                )
            else:
                coalesced.append(it)
        if not coalesced:
            return
        # at most max_pairs (query, doc) pairs per device call; a single
        # request with more documents still runs alone
        chunks: List[List[_Pending]] = [[]]
        pairs = 0
        for it in coalesced:
            nd = len(it.payload[1])
            if chunks[-1] and pairs + nd > self.max_pairs:
                chunks.append([])
                pairs = 0
            chunks[-1].append(it)
            pairs += nd
        for chunk in chunks:
            self._serve_doc_rerank_chunk(chunk)

    def _serve_doc_rerank_chunk(self, coalesced: List[_Pending]) -> None:
        qr = self.engine.controller.quantum_reranker
        try:
            # ONE embedder call + ONE device fidelity call for the group:
            # every (query, doc) pair on one pair axis
            texts: List[str] = []
            for it in coalesced:
                query, documents, _ = it.payload
                texts.append(query)
                texts.extend(d.content for d in documents)
            embeds = np.asarray(qr.embedder(texts), dtype=np.float32)
            q_rows: List[int] = []
            d_rows: List[int] = []
            spans: List[slice] = []
            off = 0  # into embeds
            for it in coalesced:
                nd = len(it.payload[1])
                spans.append(slice(len(d_rows), len(d_rows) + nd))
                q_rows.extend([off] * nd)
                d_rows.extend(range(off + 1, off + 1 + nd))
                off += 1 + nd
            pair = _pair_fidelity_fn(
                qr.n_qubits, bool(qr.config.use_analytic_fidelity), qr.config.encoding
            )
            e = torch.from_numpy(np.ascontiguousarray(embeds)).to(qr.device)
            scores = pair(e[q_rows], e[d_rows]).cpu().numpy()
            self.batches += 1
            self.batched_queries += len(coalesced)
            for it, sl in zip(coalesced, spans):
                query, documents, top_k = it.payload
                scored = [(doc, float(s)) for doc, s in zip(documents, scores[sl])]
                reranked = sorted(scored, key=lambda x: x[1], reverse=True)
                if top_k is not None:
                    reranked = reranked[:top_k]
                it.future.set_result(
                    {"documents": reranked, "reranker_used": "quantum", "query": query}
                )
        except Exception as e:  # noqa: BLE001 - per-request fallback
            for it in coalesced:
                if it.future.done():
                    continue
                query, documents, top_k = it.payload
                try:
                    it.future.set_result(
                        self.engine.controller.rerank(
                            query, documents, top_k, reranker_type="quantum"
                        )
                    )
                except Exception:  # noqa: BLE001
                    it.future.set_exception(e)

    def _serve_rerank(self, items: List[_Pending]) -> None:
        _, k, candidates, reranker_type = items[0].params
        vecs = np.concatenate([it.vectors for it in items], axis=0)
        out = self.engine.search_rerank(
            vecs, k=k, candidates=candidates, reranker_type=reranker_type
        )
        self.batches += 1
        self.batched_queries += vecs.shape[0]
        results = out["results"]
        off = 0
        for it in items:
            n = it.vectors.shape[0]
            it.future.set_result(
                {
                    "queries": n,
                    "results": results[off : off + n],
                    "reranker_used": out["reranker_used"],
                }
            )
            off += n
