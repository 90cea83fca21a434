"""Device-resident flat indexes and FAISS-format IO."""

from qrag_tpu_torch.index.faiss_io import (
    FlatIndexData,
    append_flat_index,
    append_metadata,
    metadata_path_for,
    read_flat_index,
    read_metadata,
    write_flat_index,
)
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex, SearchResult
from qrag_tpu_torch.index.quantized_index import QuantizedFlatIndex

__all__ = [
    "FlatIndexData",
    "read_flat_index",
    "write_flat_index",
    "append_flat_index",
    "read_metadata",
    "append_metadata",
    "metadata_path_for",
    "DeviceFlatIndex",
    "QuantizedFlatIndex",
    "SearchResult",
]
