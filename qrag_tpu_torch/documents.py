"""Document model for retrieval and reranking (the port's own copy of
``qrag_tpu.documents``; same class and validation).

Mirrors the semantics of the reference's ``Document`` class: id,
content, optional source and metadata dict, with an explicit
JSON-serializable schema.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Document:
    """A retrievable/rerankable document."""

    id: str
    content: str
    source: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "content": self.content,
            "source": self.source,
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Document":
        return cls(
            id=str(d["id"]),
            content=str(d["content"]),
            source=d.get("source"),
            metadata=dict(d.get("metadata") or {}),
        )


def validate_documents(query: str, documents) -> bool:
    """Input validation: False (rather than raising) on invalid input;
    callers fall back to neutral scoring, the reference's
    graceful-degradation contract."""
    if not isinstance(query, str) or not query.strip():
        return False
    if not isinstance(documents, list) or not documents:
        return False
    for doc in documents:
        if not isinstance(doc, Document):
            return False
        if not doc.content:
            return False
    return True
