"""The ingestion tools and their registry (no pydantic)."""

from qrag_tpu_torch.tools.interface import (
    BaseToolInput,
    Tool,
    ToolContent,
    ToolResponse,
)
from qrag_tpu_torch.tools.service import ToolService
from qrag_tpu_torch.tools.ingest_tools import (
    FetchEmbeddingsTool,
    ProcessTranscriptsToEmbeddingsTool,
    ReadFromS3Tool,
    StoreInFaissTool,
    default_tools,
)

__all__ = [
    "BaseToolInput",
    "Tool",
    "ToolContent",
    "ToolResponse",
    "ToolService",
    "FetchEmbeddingsTool",
    "ReadFromS3Tool",
    "StoreInFaissTool",
    "ProcessTranscriptsToEmbeddingsTool",
    "default_tools",
]
