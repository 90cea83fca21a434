"""FAISS flat-index file IO — no faiss dependency.

A numpy-only copy of ``qrag_tpu.index.faiss_io``: importing that module
would run ``qrag_tpu/index/__init__.py``, which imports jax.  Both
packages read and write the same files.

The reference persists its corpus as a FAISS ``IndexFlatL2`` file plus a
pickled metadata list (``mcp/server/tools/store_in_faiss.py:99-122``),
and ships one such artifact (``mcp/piers_morgan_faiss_index.faiss``:
fourcc ``IxF2``, d=1536, ntotal=119, unit-norm float32 rows).  This
module reads and writes that on-disk format directly so the bundled
corpus loads without faiss-cpu, and so indexes built here can be read
back by stock FAISS.

Layout (little-endian), verified against the bundled artifact:

    fourcc    4 bytes   b"IxF2" (METRIC_L2) | b"IxFI" (inner product)
    d         int32
    ntotal    int64
    dummy     int64 ×2  (1 << 20 each)
    is_trained uint8
    metric    int32     1 = L2, 0 = inner product
    count     uint64    number of float32 elements (= d * ntotal)
    data      float32 × count   row-major vectors

Metadata sidecar: a pickle of ``List[str]`` at
``index_path.replace(".faiss", "_metadata.pkl")`` with load-extend-dump
append semantics (``store_in_faiss.py:111-122``).
"""

from __future__ import annotations

import os
import pickle
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

FOURCC_L2 = b"IxF2"
FOURCC_IP = b"IxFI"
FOURCC_GENERIC = b"IxFl"  # newer faiss generic IndexFlat fourcc

METRIC_IP = 0
METRIC_L2 = 1

_DUMMY = 1 << 20


@dataclass
class FlatIndexData:
    """In-memory image of a flat index file."""

    vectors: np.ndarray  # (ntotal, d) float32
    metric: str  # "l2" | "ip"

    @property
    def d(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def ntotal(self) -> int:
        return int(self.vectors.shape[0])


def read_flat_index(path: str) -> FlatIndexData:
    """Read a FAISS flat index file (IxF2 / IxFI / IxFl)."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 4 + 4 + 8 + 16 + 1 + 4 + 8:
        raise ValueError(f"{path}: file too short to be a flat index")
    fourcc = buf[:4]
    if fourcc not in (FOURCC_L2, FOURCC_IP, FOURCC_GENERIC):
        raise ValueError(
            f"{path}: unsupported index fourcc {fourcc!r} "
            "(only flat indexes are supported)"
        )
    off = 4
    (d,) = struct.unpack_from("<i", buf, off)
    off += 4
    (ntotal,) = struct.unpack_from("<q", buf, off)
    off += 8
    off += 16  # two dummy int64s
    off += 1  # is_trained
    (metric_code,) = struct.unpack_from("<i", buf, off)
    off += 4
    (count,) = struct.unpack_from("<Q", buf, off)
    off += 8
    expected = d * ntotal
    if count != expected:
        # Newer faiss stores codes as a byte vector (count in bytes).
        if count == expected * 4:
            count = expected
        else:
            raise ValueError(
                f"{path}: element count {count} != d*ntotal {expected}"
            )
    if len(buf) - off < expected * 4:
        raise ValueError(f"{path}: truncated vector data")
    vectors = (
        np.frombuffer(buf, dtype="<f4", count=expected, offset=off)
        .reshape(ntotal, d)
        .copy()
    )
    if fourcc == FOURCC_IP or metric_code == METRIC_IP:
        metric = "ip"
    else:
        metric = "l2"
    return FlatIndexData(vectors=vectors, metric=metric)


def write_flat_index(path: str, vectors: np.ndarray, metric: str = "l2") -> None:
    """Write a FAISS-compatible flat index file."""
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    if vectors.ndim != 2:
        raise ValueError(f"vectors must be 2D, got shape {vectors.shape}")
    ntotal, d = vectors.shape
    if metric == "l2":
        fourcc, metric_code = FOURCC_L2, METRIC_L2
    elif metric == "ip":
        fourcc, metric_code = FOURCC_IP, METRIC_IP
    else:
        raise ValueError(f"unknown metric {metric!r}")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(fourcc)
        f.write(struct.pack("<i", d))
        f.write(struct.pack("<q", ntotal))
        f.write(struct.pack("<qq", _DUMMY, _DUMMY))
        f.write(struct.pack("<B", 1))  # is_trained
        f.write(struct.pack("<i", metric_code))
        f.write(struct.pack("<Q", d * ntotal))
        f.write(vectors.tobytes(order="C"))
    os.replace(tmp, path)


def append_flat_index(
    path: str, vectors: np.ndarray, metric: str = "l2"
) -> int:
    """Open-or-create + append, as ``store_in_faiss.py:102-109`` — but
    validating dimension compatibility (the reference does not;
    SURVEY.md Appendix A.6).  Returns the new ntotal.
    """
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    if os.path.exists(path):
        existing = read_flat_index(path)
        if existing.d != vectors.shape[1]:
            raise ValueError(
                f"dimension mismatch: index has d={existing.d}, "
                f"appending d={vectors.shape[1]}"
            )
        merged = np.concatenate([existing.vectors, vectors], axis=0)
        write_flat_index(path, merged, metric=existing.metric)
        return merged.shape[0]
    write_flat_index(path, vectors, metric=metric)
    return vectors.shape[0]


def read_flat_with_metadata(path: str):
    """Read a flat index + its sidecar, with metadata padded/truncated
    to ntotal (the reference tolerates count mismatches — SURVEY.md
    Appendix A.4).  Returns (FlatIndexData, List[str] | None)."""
    data = read_flat_index(path)
    meta = read_metadata(path)
    if meta and len(meta) != data.ntotal:
        meta = (meta + [""] * data.ntotal)[: data.ntotal]
    return data, (meta or None)


def metadata_path_for(index_path: str) -> str:
    """Sidecar path convention of ``store_in_faiss.py:111``."""
    if index_path.endswith(".faiss"):
        return index_path[: -len(".faiss")] + "_metadata.pkl"
    return index_path + "_metadata.pkl"


def read_metadata(index_path: str) -> List[str]:
    path = metadata_path_for(index_path)
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        meta = pickle.load(f)
    if not isinstance(meta, list):
        raise ValueError(f"{path}: metadata must be a list")
    return [str(m) for m in meta]


def append_metadata(index_path: str, entries: Sequence[str]) -> List[str]:
    """Load-extend-dump append (``store_in_faiss.py:111-122``)."""
    path = metadata_path_for(index_path)
    existing = read_metadata(index_path)
    existing.extend(str(e) for e in entries)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(existing, f)
    os.replace(tmp, path)
    return existing
