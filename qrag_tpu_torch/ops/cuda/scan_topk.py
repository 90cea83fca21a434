"""Fused scan + running top-k: the Hopper kernel's wrapper and launch
counters.

``scan_topk_cuda`` launches the CUDA C++ kernels of
``csrc/scan_topk.cu`` (which replace the Pallas kernel
``_scan_topk_kernel`` of ``qrag_tpu/ops/pallas/scan_topk.py``) or
raises.  The dispatch by device and the plain twin live in
``qrag_tpu_torch.ops.scan_topk``.

``_config`` picks the kernel's arm from the shapes: ``stream`` (a
matrix-vector arm that reads the store once per 8 queries) for B <= 8
with bf16 compute and B <= 64 with f32 compute, ``wgmma64`` and
``wgmma128`` (the tensor cores, 64 or 128 queries a block; the wider
one past B = 64, where passes over the store are what costs) for bf16
compute past that, ``tiled`` (FFMA on
128 x 128 tiles) for f32 compute at B > 64, and ``general`` for what
those do not take: k past their candidate buffers, rows that are not
16-byte aligned, a depth past their shared memory.  It
also sizes the per-query candidate buffer (a power of two that holds k
entries and one more chunk of scores), splits the rows over the blocks,
and the wrapper allocates the splits' scratch lists.  ``launches``
counts launches per compute type, ``arm_launches`` per arm.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from qrag_tpu_torch.ops.cuda import _launch
from qrag_tpu_torch.ops.scan_topk import MAX_K

launches = {"float32": 0, "bfloat16": 0}
arm_launches = {"general": 0, "stream": 0, "tiled": 0, "wgmma64": 0, "wgmma128": 0}

SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on an H100
# the kernel's arm numbers; the two wgmma arms are one template there,
# told apart by the query tile
ARM_IDS = {"general": 0, "stream": 1, "tiled": 2, "wgmma64": 3, "wgmma128": 3}
# rows that an arm offers to a query's buffer between two compactions
CHUNK = {"general": 64, "stream": 256, "tiled": 16, "wgmma64": 64, "wgmma128": 64}
# rows of one tile of an arm: a split is a whole number of them
TILE_ROWS = {"general": 64, "stream": 256, "tiled": 128, "wgmma64": 128, "wgmma128": 128}
# the stream arm reads the store once per 8 queries: the largest B at
# which it is picked for f32 and for bf16 compute (past it the general,
# tiled or wgmma arm is faster)
STREAM_MAX_B = {False: 64, True: 8}
# (arm, bf16 compute, query tile, load width in floats) that
# csrc/scan_topk.cu instantiates
INSTANCES = frozenset(
    [("stream", bf16, qt, vec) for bf16 in (False, True) for qt in (1, 8) for vec in (4, 1)]
    + [("general", bf16, qt, vec) for bf16 in (False, True) for qt in (8, 16, 64)
       for vec in (4, 1)]
    + [("tiled", False, 128, 4), ("wgmma64", True, 64, 4), ("wgmma128", True, 128, 4)]
)


class Config(NamedTuple):
    arm: str
    qt: int  # queries per block
    vec: int  # floats per load: 4 when the rows are 16-byte aligned
    buf: int  # entries of a query's candidate buffer
    splits: int
    rows: int  # rows per split


def reset_launches() -> None:
    _launch.reset(launches)
    _launch.reset(arm_launches)


def smem_bytes(arm: str, qt: int, buf: int, d: int) -> int:
    """Dynamic shared memory of one block, as the launch functions of
    ``csrc/scan_topk.cu`` compute it."""
    cand = qt * buf * 8 + qt * 12
    if arm == "stream":
        return cand + qt * (-(-d // 4) * 4) * 4
    if arm == "tiled":
        return cand + 3 * (128 + 128) * 20 * 4
    if arm in ("wgmma64", "wgmma128"):  # the wide arm's buffers are device memory
        words = qt * 16 + (-(-d // 64)) * qt * 128
        return words + (qt * buf * 8 if arm == "wgmma64" else 0)
    return cand + (qt + 64) * 36 * 4


def _buffer(k: int, chunk: int, least: int) -> int:
    buf = least
    while buf < k + chunk:
        buf *= 2
    return buf


def _config(
    b: int, n: int, k: int, d: int, bf16: bool, aligned: bool, sms: int,
    arm: Optional[str] = None,
) -> Config:
    """The arm, tile, buffer and row split for a call; ``arm`` forces
    one (for measurements) and raises if it does not take the shapes."""
    vec = 4 if aligned else 1
    choices = [("stream", 1 if b == 1 else 8, _buffer(k, CHUNK["stream"], 512))]
    if bf16 and aligned and k <= 64:
        choices.append(("wgmma64", 64, 128))
        choices.append(("wgmma128", 128, 128))
    if not bf16 and aligned and k <= 64:
        choices.append(("tiled", 128, 64 if k <= 24 else 128))
    gbuf = _buffer(k, CHUNK["general"], 128)
    gqt = (64 if b > 16 else 16) if gbuf <= 256 else (8 if gbuf == 2048 else 16)
    choices.append(("general", gqt, gbuf))
    fits = {c[0]: c for c in choices if smem_bytes(c[0], c[1], c[2], d) <= SMEM_LIMIT}
    if arm is None:
        if b <= STREAM_MAX_B[bf16] and "stream" in fits:
            arm = "stream"
        elif b > 64 and "wgmma128" in fits:
            arm = "wgmma128"
        elif "wgmma64" in fits:
            arm = "wgmma64"
        elif b > 64 and "tiled" in fits:
            arm = "tiled"
        else:
            arm = "general"
    if arm not in fits:
        raise ValueError(
            f"scan_topk kernel: the {arm} arm does not take B={b} k={k} d={d} "
            f"bf16={bf16} aligned={aligned}"
        )
    _, qt, buf = fits[arm]
    tile = TILE_ROWS[arm]
    qtiles = -(-b // qt)
    if arm == "stream":  # two resident blocks per SM, one wave
        want = -(-2 * sms // qtiles)
    elif arm == "general":
        want = -(-4 * sms // qtiles)
    else:  # one block per SM
        want = max(1, sms // qtiles)
    splits = max(1, min(want, -(-n // tile)))
    rows = -(-n // splits)
    rows = -(-rows // tile) * tile
    return Config(arm, qt, vec, buf, -(-n // rows), rows)


def plan(
    q: torch.Tensor, x: torch.Tensor, k: int, bf16: bool, arm: Optional[str] = None
) -> Config:
    """The configuration ``scan_topk_cuda`` launches for these operands
    on their card."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    aligned = q.shape[1] % 4 == 0 and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    return _config(q.shape[0], x.shape[0], k, q.shape[1], bf16, aligned, sms, arm)


def scan_topk_cuda(
    q: torch.Tensor,  # (B, d) f32
    qsq: torch.Tensor,  # (B,) f32
    x: torch.Tensor,  # (N, d) f32
    xsq: torch.Tensor,  # (N,) f32
    valid: Optional[torch.Tensor],  # (N,) bool or None
    k: int,
    l2: bool,
    bf16: bool,
    arm: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (B, k) goodness and int32 indices from the kernel; sentinel
    slots (finfo(f32).min, -1).  ``arm`` forces one arm of the kernel
    (to time it against another); it never selects the plain twin."""
    dev = x.device
    tensors = (q, qsq, x, xsq) if valid is None else (q, qsq, x, xsq, valid)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "scan_topk kernel: every operand on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in (q, qsq, x, xsq)) or (
        valid is not None and valid.dtype != torch.bool
    ):
        raise TypeError("scan_topk kernel takes f32 operands and a bool mask")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("scan_topk kernel needs contiguous operands")
    b, d = q.shape
    n = x.shape[0]
    if k > MAX_K:
        raise ValueError(f"scan_topk kernel takes k <= {MAX_K}, got k={k}")
    if n >= 2**31:
        raise ValueError(f"scan_topk kernel indexes rows in int32, got N={n}")
    cfg = plan(q, x, k, bf16, arm)
    pv = torch.empty((cfg.splits, b, k), dtype=torch.float32, device=dev)
    pi = torch.empty((cfg.splits, b, k), dtype=torch.int32, device=dev)
    ov = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int32, device=dev)
    gbuf = None
    if cfg.arm == "wgmma128":  # its candidate buffers: 8-byte entries
        blocks = cfg.splits * -(-b // cfg.qt)
        gbuf = torch.empty((blocks, cfg.qt, cfg.buf, 2), dtype=torch.int32, device=dev)
    _launch.launch(
        "qrag_scan_topk", dev, launches, "bfloat16" if bf16 else "float32",
        q.data_ptr(), qsq.data_ptr(), x.data_ptr(), xsq.data_ptr(),
        None if valid is None else valid.data_ptr(), b, n, d, k, l2, bf16,
        ARM_IDS[cfg.arm], cfg.qt, cfg.vec, cfg.buf, cfg.splits, cfg.rows,
        pv.data_ptr(), pi.data_ptr(), ov.data_ptr(), oi.data_ptr(),
        None if gbuf is None else gbuf.data_ptr(),
    )
    _launch.count(arm_launches, cfg.arm)
    return ov, oi
