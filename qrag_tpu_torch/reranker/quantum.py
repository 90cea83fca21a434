"""Quantum fidelity reranker (PyTorch port of
``qrag_tpu.reranker.quantum``).

All candidates are scored in one batched device op
(``ops.statevector``): the rotation-encoding circuit's fidelity by the
analytic product form (default) or the full 2^n statevector
(``use_analytic_fidelity=False``), or with ``encoding="amplitude"`` the
amplitude-encoded fidelity.  The graceful-degradation contract is kept:
a scoring failure falls back to the classical reranker, which in turn
degrades to neutral scores; a method other than "state_fidelity"
returns the reference's flat 0.5 scores.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from qrag_tpu_torch.config import QuantumConfig
from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.documents import Document, validate_documents
from qrag_tpu_torch.ops.statevector import amplitude_fidelity, batched_fidelity
from qrag_tpu_torch.pipeline.embeddings import Embedder, MockEmbedder
from qrag_tpu_torch.reranker.classical import ClassicalReranker

logger = logging.getLogger(__name__)


class QuantumReranker:
    """Statevector-fidelity reranker, batched on the device."""

    def __init__(
        self,
        config: Optional[QuantumConfig] = None,
        embedder: Optional[Embedder] = None,
        classical_fallback: Optional[ClassicalReranker] = None,
        device=None,
    ):
        self.config = config or QuantumConfig()
        self.n_qubits = self.config.n_qubits
        self.device = resolve_device(device)
        # reference default embedder: deterministic mock of dim n_qubits*2
        self.embedder = embedder or MockEmbedder(dim=self.n_qubits * 2)
        self.classical_fallback = classical_fallback or ClassicalReranker(
            device=self.device
        )

    def score_documents(self, query: str, documents: List[Document]) -> np.ndarray:
        """Fidelity scores |<psi_q|psi_d>|^2 for all documents, one
        batched device call."""
        embeds = np.asarray(
            self.embedder([query] + [doc.content for doc in documents]), dtype=np.float32
        )
        e = torch.from_numpy(np.ascontiguousarray(embeds)).to(self.device)
        if self.config.encoding == "amplitude":
            scores = amplitude_fidelity(e[0], e[1:], self.n_qubits)
        else:
            scores = batched_fidelity(
                e[0], e[1:], n_qubits=self.n_qubits,
                analytic=self.config.use_analytic_fidelity,
            )
        return scores.cpu().numpy().astype(np.float32)

    def rerank(
        self,
        query: str,
        documents: List[Document],
        top_k: Optional[int] = None,
    ) -> List[Tuple[Document, float]]:
        if not documents:
            return []
        if not validate_documents(query, documents):
            return self.classical_fallback.rerank(query, documents, top_k)
        if self.config.method != "state_fidelity":
            # the reference's non-state_fidelity branch: flat 0.5 scores
            scored = [(doc, 0.5) for doc in documents]
        else:
            try:
                t0 = time.time()
                scores = self.score_documents(query, documents)
                logger.debug(
                    "fidelity scoring of %d docs in %.4fs",
                    len(documents),
                    time.time() - t0,
                )
                scored = [(doc, float(s)) for doc, s in zip(documents, scores)]
            except Exception as e:  # noqa: BLE001 - fallback contract
                logger.warning(
                    "quantum scoring failed (%s); falling back to classical", e
                )
                return self.classical_fallback.rerank(query, documents, top_k)

        reranked = sorted(scored, key=lambda x: x[1], reverse=True)
        if top_k is not None:
            reranked = reranked[:top_k]
        return reranked
