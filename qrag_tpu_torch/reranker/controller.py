"""Quantum-vs-classical routing controller (PyTorch port of
``qrag_tpu.reranker.controller``).

The reference's routing semantics exactly: a query routes to "quantum"
iff its word count exceeds ``complexity_threshold`` (default 8) OR any
lower-cased whitespace token *contains* one of the ad keywords as a
substring (so "add" fires on "ad" — a documented quirk).  Responses
keep the reference's shape (``{"documents": [(Document, score), ...],
"reranker_used", "query"}``); ``rerank_response_dict`` gives the
explicit JSON schema.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from qrag_tpu_torch.config import ControllerConfig, QragConfig
from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.documents import Document
from qrag_tpu_torch.reranker.classical import ClassicalReranker
from qrag_tpu_torch.reranker.quantum import QuantumReranker


class RerankerController:
    """Routes queries between the quantum and classical rerankers."""

    def __init__(
        self,
        config: Optional[QragConfig] = None,
        classical: Optional[ClassicalReranker] = None,
        quantum: Optional[QuantumReranker] = None,
        device=None,
    ):
        self.config = config or QragConfig()
        self.controller_config: ControllerConfig = self.config.controller
        device = resolve_device(device)
        self.classical_reranker = classical or ClassicalReranker(
            self.config.classical, device=device
        )
        # one classical instance, shared as the quantum fallback
        self.quantum_reranker = quantum or QuantumReranker(
            self.config.quantum, classical_fallback=self.classical_reranker,
            device=device,
        )

    def select_reranker(self, query: str) -> str:
        """The reference's routing truth table."""
        words = query.lower().split()
        complexity = len(words)
        keyword_matches = sum(
            1
            for word in words
            if any(kw in word for kw in self.controller_config.quantum_keywords)
        )
        if (
            complexity > self.controller_config.complexity_threshold
            or keyword_matches > 0
        ):
            return "quantum"
        return "classical"

    def rerank(
        self,
        query: str,
        documents: List[Document],
        top_k: Optional[int] = None,
        reranker_type: str = "auto",
    ) -> Dict[str, Any]:
        selected = self.select_reranker(query) if reranker_type == "auto" else reranker_type
        if selected == "quantum":
            reranked = self.quantum_reranker.rerank(query, documents, top_k)
            used = "quantum"
        else:
            reranked = self.classical_reranker.rerank(query, documents, top_k)
            used = "classical"
        return {"documents": reranked, "reranker_used": used, "query": query}


def rerank_response_dict(result: Dict[str, Any]) -> Dict[str, Any]:
    """Explicit JSON-serializable response schema."""
    return {
        "documents": [
            {"document": doc.to_dict(), "score": float(score)}
            for doc, score in result["documents"]
        ],
        "reranker_used": result["reranker_used"],
        "query": result["query"],
    }
