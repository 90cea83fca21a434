"""Build and load the port's CUDA kernels.

Every ``qrag_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, at
first use, into ``build/qrag_tpu_torch/<hash of the sources>/`` under
the checkout root, and loaded with ``ctypes``.  One ``nvcc`` per source
runs, all started together, then one link.  A changed source gets a new
directory, so a stale library is never loaded.  Nothing here runs at
import: the CPU-only test environment has no ``nvcc``.
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
from typing import Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "qrag_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# -ldl: fused_scan.cu looks the tensor-map encoder up in the loaded libcuda
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-ldl")
LIB_NAME = "libqrag_tpu_torch.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process printed (ptxas register and
# shared-memory report); None when the library was already built
build_log: Optional[str] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the qrag_tpu_torch "
        "CUDA kernels are compiled at first use on the GPU host"
    )


def _sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def library_path(csrc: Path = CSRC, build_root: Path = BUILD_ROOT) -> Path:
    """Where the library for the sources of ``csrc`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_root / h.hexdigest()[:16] / LIB_NAME


def build_library(csrc: Path = CSRC, build_root: Path = BUILD_ROOT):
    """Compile the ``*.cu`` of ``csrc`` unless its library exists;
    returns (path, nvcc output or None)."""
    path = library_path(csrc, build_root)
    if path.exists():
        return path, None
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a temporary directory and rename the library: a
    # concurrent process never loads a half-written one
    work = Path(tempfile.mkdtemp(dir=path.parent))
    try:
        cu = [s for s in _sources(csrc) if s.suffix == ".cu"]
        objs = [work / f"{s.stem}.o" for s in cu]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for s, o in zip(cu, objs)
        ]
        outs = [p.communicate() for p in procs]
        failed = [
            f"{s.name} ({p.returncode}):\n{err}"
            for s, p, (_, err) in zip(cu, procs, outs)
            if p.returncode != 0
        ]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = work / LIB_NAME
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed (link, {link.returncode}):\n{link.stderr}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path, "".join(out + err for out, err in outs)


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    L, F = ctypes.c_longlong, ctypes.c_float
    # an older build (scan_ab's other side) has the scan's entry points
    # of before the arms, and may predate the int8 domain and the gather
    # and scan_topk kernels
    signatures = {
        "qrag_window_scan_bf16": [P, P, P, P, I, I, I, F, I, I, I, I, P, P, P, P],
        "qrag_window_scan_int8": [P, P, I, I, I, I, I, I, I, P, P, P],
        "qrag_packed_window_scan": [P, P, P, P, I, I, I, F, I, P, P, P, P],
        "qrag_packed_window_scan_int8": [P, P, I, I, I, I, P, P, P],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
    if hasattr(lib, "qrag_gather_rows"):
        g = lib.qrag_gather_rows
        g.argtypes = [P, P, I, L, L, L, P, P]
        g.restype = I
    if hasattr(lib, "qrag_scan_topk"):
        s = lib.qrag_scan_topk
        s.argtypes = [P, P, P, P, P, I, L, I, I, I, I, I, I, I, I, I, L, P, P, P, P, P, P]
        s.restype = I
    return lib


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path, log = build_library(CSRC, BUILD_ROOT)
            if log is not None:
                build_log = log
            _lib = bind(path)
        return _lib
