"""Packed (score | lane) window keys — the plane contract of the scan.

PyTorch port of the packing helpers of ``qrag_tpu.ops.window_scan``.
Each 128-row window of the (B, N) score matrix reduces to int32 keys
that carry an order-preserving image of the f32 score in the high bits
and ``127 - lane`` in the low 7 bits, so a plain integer max picks the
best row and breaks ties toward the LOWER global index:

    key    = sign-fold(bitcast_int32(score)) & ~127
    packed = key | (127 - (row % 128))

``windowed_scan_topk`` and the int8 block quantizers of the reference
module are not ported yet (ROADMAP.md, Queue 1 slice 5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

WINDOW = 128
_I32_MIN = -(2 ** 31)
_INT_CLAMP = (1 << 23) - 1  # |key| <= 2^23 so << 7 never overflows


def _float_sort_key(x_f32: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> int32 (IEEE sign-fold)."""
    u = x_f32.to(torch.float32).view(torch.int32)
    return torch.where(u < 0, _I32_MIN - u, u)


def _float_from_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_float_sort_key`` (low bits already cleared)."""
    u = torch.where(key < 0, _I32_MIN - key, key)
    return u.view(torch.float32)


def make_lane_rank(
    n: int, device: Optional[torch.device] = None
) -> torch.Tensor:
    """(1, N) int32 lane-rank plane: 127 - (col % 128), so packed ties
    resolve to the LOWER global index (``lax.top_k`` parity)."""
    cols = torch.arange(n, dtype=torch.int32, device=device)
    return (127 - cols % WINDOW)[None, :]


def unpack_stats(
    wstat: torch.Tensor, int_domain: bool, int_shift: int = 7
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, NW) packed -> (approx score f32 / int32-scaled, lane idx)."""
    lane = WINDOW - 1 - (wstat & (WINDOW - 1))
    if int_domain:
        return (wstat >> int_shift).to(torch.float32), lane
    return _float_from_key(wstat & ~(WINDOW - 1)), lane
