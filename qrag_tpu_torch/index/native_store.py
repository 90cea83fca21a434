"""ctypes bindings for the native host index store (PyTorch port of
``qrag_tpu.index.native_store``).

``NativeVectorStore`` is the host tier of the index: an mmap-backed
append-only float32 row store with a binary header and a C++ exact
scan + top-k (lower-index ties), plus the C++ cluster-pruned exact
search over variable-size host clusters (``HostClusters``).  It is the
host oracle of ``ops.cluster_topk``, not a fallback of the device path;
``to_device_index`` loads its rows into the port's ``DeviceFlatIndex``
on the card.

The C++ source is the package's own copy, ``native/indexstore.cpp``
(byte-identical to the reference's).  It is compiled with ``g++`` at
first use into ``build/qrag_tpu_torch/native/<hash>/`` under the
checkout root, where the hash covers the source, the flags and the
instruction set ``-march=native`` selects on this host, so a library
built on another host is never loaded.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "indexstore.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "qrag_tpu_torch" / "native"
# the reference's Makefile flags
CXX_FLAGS = ("-O3", "-std=c++20", "-fPIC", "-Wall", "-march=native", "-pthread", "-shared")
LIB_NAME = "libqidx.so"

_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

METRIC_IP = 0
METRIC_L2 = 1


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) on PATH: the native store builds at first use")
    return found


def library_path(build_root: Path = BUILD_ROOT) -> Path:
    """Where the library for this source, these flags and this host's
    ``-march=native`` target lives."""
    cxx = _cxx()
    target = subprocess.run(
        [cxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True, check=True,
    ).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(target.encode())
    return build_root / h.hexdigest()[:16] / LIB_NAME


def build_library(build_root: Path = BUILD_ROOT) -> Path:
    """Compile the store unless its library exists; returns its path.
    The library is written in a temporary directory and renamed, so a
    concurrent process never loads a half-written one."""
    path = library_path(build_root)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=path.parent))
    try:
        tmp = work / LIB_NAME
        out = subprocess.run(
            [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed ({out.returncode}):\n{out.stderr}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path


def _bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare every entry point."""
    lib = ctypes.CDLL(str(path))
    c = ctypes
    F, I64 = c.POINTER(c.c_float), c.POINTER(c.c_int64)
    I32, U32 = c.POINTER(c.c_int32), c.POINTER(c.c_uint32)
    sigs = {
        "qidx_open": (c.c_void_p, [c.c_char_p, c.c_uint32, c.c_uint32, c.c_uint32, c.c_int]),
        "qidx_dim": (c.c_uint32, [c.c_void_p]),
        "qidx_metric": (c.c_uint32, [c.c_void_p]),
        "qidx_normalized": (c.c_uint32, [c.c_void_p]),
        "qidx_ntotal": (c.c_uint64, [c.c_void_p]),
        "qidx_append": (c.c_int64, [c.c_void_p, F, c.c_uint64]),
        "qidx_read": (c.c_int, [c.c_void_p, c.c_uint64, c.c_uint64, F]),
        "qidx_flush": (c.c_int, [c.c_void_p]),
        "qidx_close": (None, [c.c_void_p]),
        "qidx_scan_topk": (None, [c.c_void_p, F, c.c_uint64, c.c_uint32, F, I64]),
        "qidx_raw_scan_topk": (
            None,
            [F, c.c_uint64, c.c_uint32, F, c.c_uint64, c.c_uint32, c.c_uint32, F, I64],
        ),
        "qidx_raw_scan_topk_mt": (
            None,
            [F, c.c_uint64, c.c_uint32, F, c.c_uint64, c.c_uint32, c.c_uint32,
             c.c_uint32, F, I64],
        ),
        "qidx_scan_topk_mt": (
            None, [c.c_void_p, F, c.c_uint64, c.c_uint32, c.c_uint32, F, I64],
        ),
        # store, xsq, order, goff, cent, csq, radii, mxn, G, q, b, k,
        # budget, out scores, out idx, stats
        "qidx_cluster_topk": (
            None,
            [c.c_void_p, F, I32, I64, F, F, F, F, c.c_uint32, F, c.c_uint64,
             c.c_uint32, c.c_uint32, F, I64, U32],
        ),
        # x, n, d, xsq, order, goff, cent, csq, radii, mxn, G, q, b, k,
        # metric, budget, threads, out scores, out idx, stats
        "qidx_raw_cluster_topk_mt": (
            None,
            [F, c.c_uint64, c.c_uint32, F, I32, I64, F, F, F, F, c.c_uint32, F,
             c.c_uint64, c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32, F, I64, U32],
        ),
        # as above without threads
        "qidx_raw_cluster_topk": (
            None,
            [F, c.c_uint64, c.c_uint32, F, I32, I64, F, F, F, F, c.c_uint32, F,
             c.c_uint64, c.c_uint32, c.c_uint32, c.c_uint32, F, I64, U32],
        ),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_library() -> ctypes.CDLL:
    """Compile (once per source, flags and host target) and load the
    native store's library."""
    global _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            _LIB = _bind(build_library(BUILD_ROOT))
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _queries(queries: np.ndarray) -> np.ndarray:
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    return queries[None, :] if queries.ndim == 1 else queries


class NativeVectorStore:
    """mmap-backed append-only vector store (single writer, torn-read
    safe for concurrent readers, one handle per thread)."""

    def __init__(
        self,
        path: str,
        d: int = 0,
        metric: str = "l2",
        normalized: bool = False,
        writable: bool = True,
    ):
        self._lib = load_library()
        metric_code = METRIC_L2 if metric == "l2" else METRIC_IP
        self._handle = self._lib.qidx_open(
            path.encode(), d, metric_code, int(normalized), int(writable)
        )
        if not self._handle:
            raise OSError(
                f"cannot open native store {path!r} "
                "(missing file, bad magic, or d mismatch)"
            )
        self.path = path
        self._clusters = None  # (key, HostClusters) of build_clusters

    # ---------------------------------------------------------- properties

    @property
    def d(self) -> int:
        return int(self._lib.qidx_dim(self._handle))

    @property
    def ntotal(self) -> int:
        return int(self._lib.qidx_ntotal(self._handle))

    @property
    def metric(self) -> str:
        return "l2" if self._lib.qidx_metric(self._handle) == METRIC_L2 else "ip"

    @property
    def normalized(self) -> bool:
        return bool(self._lib.qidx_normalized(self._handle))

    # ------------------------------------------------------------------ ops

    def append(self, rows: np.ndarray) -> int:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(f"expected (*, {self.d}) rows, got {rows.shape}")
        total = self._lib.qidx_append(self._handle, _fptr(rows), rows.shape[0])
        if total < 0:
            raise OSError("append failed (read-only store or IO error)")
        return int(total)

    def read(self, start: int = 0, n: Optional[int] = None) -> np.ndarray:
        n = self.ntotal - start if n is None else n
        out = np.empty((n, self.d), np.float32)
        if n and self._lib.qidx_read(self._handle, start, n, _fptr(out)) != 0:
            raise IndexError(f"read [{start}, {start + n}) out of range")
        return out

    def flush(self) -> None:
        self._lib.qidx_flush(self._handle)

    def build_clusters(
        self, rows_per_cluster: int = 2048, iters: int = 6, seed: int = 0
    ) -> "HostClusters":
        """Build (and cache) the host cluster structure over the store's
        current rows; an append invalidates it (the ntotal key)."""
        key = (self.ntotal, rows_per_cluster, iters, seed)
        if self._clusters is not None and self._clusters[0] == key:
            return self._clusters[1]
        clusters = build_host_clusters(
            self.read(), rows_per_cluster=rows_per_cluster, iters=iters, seed=seed
        )
        self._clusters = (key, clusters)
        return clusters

    def cluster_topk(
        self,
        queries: np.ndarray,
        k: int,
        clusters: Optional["HostClusters"] = None,
        budget: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Cluster-pruned PROVABLY-EXACT top-k over the mmap'd rows in
        place.  Returns (scores, indices, stats (fallback queries,
        escalated queries))."""
        if clusters is None:
            clusters = self.build_clusters()
        queries = _queries(queries)
        b = queries.shape[0]
        if budget <= 0:
            budget = max(8, 2 * k)
        scores = np.empty((b, k), np.float32)
        idx = np.empty((b, k), np.int64)
        stats = np.zeros((2,), np.uint32)
        order = np.ascontiguousarray(clusters.order, np.int32)
        goff = np.ascontiguousarray(clusters.goff, np.int64)
        self._lib.qidx_cluster_topk(
            self._handle,
            *clusters._pointers(order, goff),
            _fptr(queries), b, k, budget,
            _fptr(scores), _iptr(idx, ctypes.c_int64), _iptr(stats, ctypes.c_uint32),
        )
        return scores, idx, stats

    def scan_topk(
        self, queries: np.ndarray, k: int, threads: int = 1
    ) -> Tuple[np.ndarray, np.ndarray]:
        """C++ exact scan: (scores, indices); L2 distances ascending / IP
        descending, -1 indices when ntotal < k.  ``threads``: 1 = the
        deterministic single-thread oracle, 0 = all cores, >1 = that
        many (identical results)."""
        queries = _queries(queries)
        b = queries.shape[0]
        scores = np.empty((b, k), np.float32)
        idx = np.empty((b, k), np.int64)
        out_i = _iptr(idx, ctypes.c_int64)
        if threads == 1:
            self._lib.qidx_scan_topk(self._handle, _fptr(queries), b, k, _fptr(scores), out_i)
        else:
            self._lib.qidx_scan_topk_mt(
                self._handle, _fptr(queries), b, k, threads, _fptr(scores), out_i
            )
        return scores, idx

    def close(self) -> None:
        if self._handle:
            self._lib.qidx_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------- bridges

    def to_device_index(self, **kwargs):
        """The store's rows in the port's ``DeviceFlatIndex`` (on the
        card unless ``device="cpu"`` is passed)."""
        from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

        return DeviceFlatIndex.from_numpy(self.read(), metric=self.metric, **kwargs)


def cpu_scan_topk(
    x: np.ndarray,
    queries: np.ndarray,
    k: int,
    metric: str = "l2",
    threads: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """C++ exact scan over a raw host matrix: the CPU oracle (threads=1)
    and its parallel variant (identical results, tie order included)."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    queries = _queries(queries)
    b = queries.shape[0]
    scores = np.empty((b, k), np.float32)
    idx = np.empty((b, k), np.int64)
    out_i = _iptr(idx, ctypes.c_int64)
    metric_code = METRIC_L2 if metric == "l2" else METRIC_IP
    common = (_fptr(x), x.shape[0], x.shape[1], _fptr(queries), b, k, metric_code)
    if threads == 1:
        lib.qidx_raw_scan_topk(*common, _fptr(scores), out_i)
    else:
        lib.qidx_raw_scan_topk_mt(*common, threads, _fptr(scores), out_i)
    return scores, idx


class HostClusters:
    """Variable-size cluster structure of the native cluster-pruned
    exact search (the host twin of ``ops.cluster_topk``).  Any
    assignment yields a correct structure; quality sets the pruning
    rate."""

    def __init__(self, order, goff, cent, csq, radii, mxn, xsq):
        self.order = order  # (n,) int32 row ids grouped by cluster
        self.goff = goff  # (G+1,) int64 offsets into order
        self.cent = cent  # (G, d) f32
        self.csq = csq  # (G,) f32
        self.radii = radii  # (G,) f32 (inflated)
        self.mxn = mxn  # (G,) f32 (inflated)
        self.xsq = xsq  # (n,) f32 row squared norms (build-time)
        # contiguous f32 copies whose pointers the C side reads; they
        # live as long as the structure
        self._f32 = [
            np.ascontiguousarray(a, np.float32)
            for a in (xsq, cent, csq, radii, mxn)
        ]

    def _pointers(self, order: np.ndarray, goff: np.ndarray):
        """(xsq, order, goff, cent, csq, radii, mxn, G) as the C entry
        points take them."""
        xsq, cent, csq, radii, mxn = self._f32
        return (
            _fptr(xsq), _iptr(order, ctypes.c_int32), _iptr(goff, ctypes.c_int64),
            _fptr(cent), _fptr(csq), _fptr(radii), _fptr(mxn), self.cent.shape[0],
        )


def build_host_clusters(
    x: np.ndarray,
    rows_per_cluster: int = 2048,
    iters: int = 6,
    seed: int = 0,
) -> HostClusters:
    """NumPy Lloyd k-means + per-cluster stats with the reference's
    inflation discipline (radii and max norms scaled by 1 + ~d*eps, csq
    not inflated: for l2 a larger csq would understate the bound)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    if n == 0:
        # zero clusters: every query rides the (empty) fallback
        return HostClusters(
            np.zeros((0,), np.int32), np.zeros((1,), np.int64),
            np.zeros((0, d), np.float32), np.zeros((0,), np.float32),
            np.zeros((0,), np.float32), np.zeros((0,), np.float32),
            np.zeros((0,), np.float32),
        )
    g = max(1, n // max(rows_per_cluster, 1))
    rng = np.random.default_rng(seed)
    cent = x[np.sort(rng.choice(n, size=g, replace=False))].astype(np.float64)
    x64 = x.astype(np.float64)
    assign = np.zeros((n,), np.int64)
    for _ in range(max(iters, 1)):
        for s in range(0, n, 65536):  # chunked assignment
            dots = x64[s : s + 65536] @ cent.T
            assign[s : s + 65536] = np.argmax(
                dots - 0.5 * np.sum(cent * cent, axis=1)[None, :], axis=1
            )
        sums = np.zeros_like(cent)
        np.add.at(sums, assign, x64)
        counts = np.bincount(assign, minlength=g).astype(np.float64)
        nonzero = counts > 0
        cent[nonzero] = sums[nonzero] / counts[nonzero, None]

    order = np.argsort(assign, kind="stable").astype(np.int32)
    sizes = np.bincount(assign, minlength=g)
    goff = np.zeros((g + 1,), np.int64)
    goff[1:] = np.cumsum(sizes)
    centf = cent.astype(np.float32)
    infl = np.float32(1.0 + 4.0e-7 * max(d, 768))
    radii = np.zeros((g,), np.float32)
    mxn = np.zeros((g,), np.float32)
    for c in range(g):
        rows = x[order[goff[c] : goff[c + 1]]]
        if rows.shape[0] == 0:
            continue
        diff = rows.astype(np.float64) - cent[c][None, :]
        radii[c] = np.sqrt((diff * diff).sum(axis=1).max()) * infl + 1e-20
        mxn[c] = np.sqrt((rows.astype(np.float64) ** 2).sum(axis=1).max()) * infl + 1e-20
    csq = np.sum(centf.astype(np.float64) * centf, axis=1).astype(np.float32)
    xsq = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)
    return HostClusters(order, goff, centf, csq, radii, mxn, xsq)


def raw_cluster_topk(
    x: np.ndarray,
    clusters: HostClusters,
    queries: np.ndarray,
    k: int,
    metric: str = "l2",
    budget: int = 0,
    threads: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster-pruned PROVABLY-EXACT top-k over a raw host matrix.
    Returns (scores finalized as ``cpu_scan_topk``'s, indices, stats
    (fallback queries, escalated queries)).  Certificate failures
    escalate 4x, then run the exact full scan per query."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    queries = _queries(queries)
    b = queries.shape[0]
    n, d = x.shape
    if budget <= 0:
        budget = max(8, 2 * k)
    scores = np.empty((b, k), np.float32)
    idx = np.empty((b, k), np.int64)
    stats = np.zeros((2,), np.uint32)
    order = np.ascontiguousarray(clusters.order, np.int32)
    goff = np.ascontiguousarray(clusters.goff, np.int64)
    pointers = clusters._pointers(order, goff)
    common = (
        _fptr(x), n, d, *pointers, _fptr(queries), b, k,
        METRIC_L2 if metric == "l2" else METRIC_IP, budget,
    )
    outs = (_fptr(scores), _iptr(idx, ctypes.c_int64), _iptr(stats, ctypes.c_uint32))
    if threads == 1:
        lib.qidx_raw_cluster_topk(*common, *outs)
    else:
        lib.qidx_raw_cluster_topk_mt(*common, threads, *outs)
    return scores, idx, stats
