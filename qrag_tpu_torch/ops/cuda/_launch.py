"""The one launch path of the port's CUDA kernels.

``launch`` calls a C entry point of the kernels' library on PyTorch's
current stream of the operands' device, raises on the
``cudaGetLastError()`` it returns, and counts the launch.  The three
wrappers (``fused_scan``, ``gather_rows``, ``scan_topk``) go through it,
so a call pays, on the host: one dictionary lookup for the bound C
function (the library is built and loaded at the first call), one
``current_device`` query (the device guard is entered only for another
device than the current one), one call for the raw stream handle, the
ctypes call with the argument types declared once in ``_build.bind``,
and one uncontended lock around the counter (worker threads of the
batcher launch concurrently, and ``+=`` on a dictionary entry is not
atomic).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable

import torch

_fns: Dict[str, Callable] = {}
_count_lock = threading.Lock()


def entry_point(name: str) -> Callable:
    """The bound C function ``name``; the first call builds and loads
    the library."""
    fn = _fns.get(name)
    if fn is None:
        from qrag_tpu_torch.ops.cuda._build import load_library

        fn = _fns[name] = getattr(load_library(), name)
    return fn


def launch(name: str, dev: torch.device, counts: dict, key: Hashable, *args) -> None:
    """``name(*args, stream)`` on the current stream of ``dev``; adds
    one to ``counts[key]`` after a launch that the runtime accepted."""
    fn = _fns.get(name) or entry_point(name)
    index = dev.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: cudaError {err}")
    count(counts, key)


def count(counts: dict, key: Hashable) -> None:
    with _count_lock:
        counts[key] += 1


def reset(counts: dict) -> None:
    with _count_lock:
        for key in counts:
            counts[key] = 0
