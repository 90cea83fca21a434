"""Device selection: CUDA by default, the CPU only when asked for."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.  A CUDA
    device on a machine without CUDA raises — the plain-torch CPU path
    runs only when the caller asks for ``cpu`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the plain PyTorch path"
        )
    return dev
