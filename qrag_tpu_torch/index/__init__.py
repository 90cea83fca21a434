"""Device-resident flat indexes and FAISS-format IO."""

from qrag_tpu_torch.index.flat_index import DeviceFlatIndex, SearchResult
from qrag_tpu_torch.index.quantized_index import QuantizedFlatIndex

__all__ = ["DeviceFlatIndex", "QuantizedFlatIndex", "SearchResult"]
