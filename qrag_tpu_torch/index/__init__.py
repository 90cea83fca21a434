"""Device-resident flat index and FAISS-format IO."""

from qrag_tpu_torch.index.flat_index import DeviceFlatIndex, SearchResult

__all__ = ["DeviceFlatIndex", "SearchResult"]
