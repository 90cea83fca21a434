"""Build and load the port's CUDA kernels.

Every ``qrag_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, at
first use, into ``build/qrag_tpu_torch/<hash of the sources>/`` under
the checkout root, and loaded with ``ctypes``.  A changed source gets a
new directory, so a stale library is never loaded.  Nothing here runs
at import: the CPU-only test environment has no ``nvcc``.
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
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


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            # compile to a temporary name and rename: a concurrent
            # process never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
            os.close(fd)
            cu = [str(s) for s in _sources() if s.suffix == ".cu"]
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, path)
            build_log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(path))
        fn = lib.qrag_packed_window_scan
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib
