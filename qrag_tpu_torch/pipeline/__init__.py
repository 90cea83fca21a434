"""Ingestion helpers: text chunking and embedding providers."""

from qrag_tpu_torch.pipeline.chunker import chunk_text
from qrag_tpu_torch.pipeline.embeddings import (
    HashEmbedder,
    MockEmbedder,
    OpenAIEmbedder,
    get_embedder,
)

__all__ = [
    "chunk_text",
    "MockEmbedder",
    "HashEmbedder",
    "OpenAIEmbedder",
    "get_embedder",
]
