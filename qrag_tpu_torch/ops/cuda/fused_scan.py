"""Packed window scan: the Hopper kernel and its dispatch.

``packed_window_scan`` is the one entry point of every windowed scan of
the port: the bounded-exact fronts (``bounded_topk.window_bounds_bf16``
and ``window_bounds_int8``, ``int8_domain.exact_topk_int8_domain``) and
``window_scan.windowed_scan_topk``.  A CUDA tensor launches the CUDA C++
kernel of ``csrc/fused_scan.cu`` (which replaces the Pallas kernels
``_packed_top2_t_kernel``, ``_packed_top2_kernel``, ``_packed_kernel``
and ``_packed_t_kernel`` of ``qrag_tpu/ops/pallas/fused_scan.py``) or
raises; a CPU tensor runs the plain PyTorch twins
(``window_scan.packed_window_scan`` for planes=1,
``bounded_topk.packed_window_scan_top2/top3/top2_int`` otherwise).

Domains: bf16 queries and corpus (the float domain, planes 1-3, with
the affine terms ``alpha``, ``row_add`` and ``col_add``) or int8 codes
(planes 1-2, raw int32 dots, no affine terms).

The kernel has two arms per domain, and ``_config`` picks one from the
shapes: ``wide`` (persistent blocks of 128 queries x 256 rows on
``wgmma``, fed by TMA; in clusters of two blocks that share the corpus
rows where there are two or more query tiles) from ``WIDE_MIN_B``
queries on, if ``d`` is a whole number of 128-byte slabs; ``general``
(one 128-row window x 16 or 64 queries a block, any ``d % 16 == 0``)
for everything else: the B = 1 launch, and depths that are no whole
slab.  Only ``packed_window_scan_cuda`` takes ``arm=`` (to hold one arm
against the other); ``plan`` names the configuration a call launches.

``launches`` counts kernel launches per (domain, planes), so a run can
show that its main path went through the kernel; ``arm_launches`` counts
them per arm.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from qrag_tpu_torch.ops.cuda import _launch
from qrag_tpu_torch.ops.window_scan import WINDOW

launches = {
    ("bf16", 1): 0, ("bf16", 2): 0, ("bf16", 3): 0,
    ("int8", 1): 0, ("int8", 2): 0,
}
arm_launches = {"general": 0, "wide": 0}

ARM_IDS = {"general": 0, "wide": 1}  # the kernel's arm numbers
WIDE_QT, WIDE_ROWS = 128, 256  # the wide arm's tile: queries x corpus rows
SLAB = {False: 64, True: 128}  # columns of a 128-byte slab: bf16, int8
# The least B at which the wide arm is picked, bf16 and int8.  On an
# NVIDIA H100 80GB HBM3 (700.00 W power limit) at N=1,250,176, d=768 the
# wide arm is the faster one at every B from 2 to 256 (device time,
# planes=2, chip_smoke.py's cut_timings: B=2 0.63 against 0.74 ms bf16,
# 0.32 against 0.47 int8; B=256 0.79 against 4.09, 0.43 against 2.83).
# The single-query launch (the latency path) is kept on the general arm
# at 0.74 / 0.46 ms, 78% and 62% of its bytes bound; the wide arm
# measured 0.64 / 0.32 ms there.
WIDE_MIN_B = {False: 2, True: 2}


class Config(NamedTuple):
    arm: str
    cluster: int  # blocks that share a slab of corpus rows (wide arm)
    grid: int  # blocks


def reset_launches() -> None:
    _launch.reset(launches)
    _launch.reset(arm_launches)


def _config(
    b: int, n: int, d: int, int8: bool, sms: int, arm: Optional[str] = None
) -> Config:
    """The arm, cluster size and grid for a call; ``arm`` forces one
    (for measurements) and raises if it does not take the shapes."""
    nw = n // WINDOW
    wide_fits = d % SLAB[int8] == 0
    if arm is None:
        arm = "wide" if wide_fits and b >= WIDE_MIN_B[int8] else "general"
    if arm not in ARM_IDS or (arm == "wide" and not wide_fits):
        raise ValueError(
            f"packed_window_scan kernel: the {arm} arm does not take B={b} N={n} "
            f"d={d} {'int8' if int8 else 'bf16'}"
        )
    if arm == "general":
        return Config(arm, 1, nw * -(-b // (64 if b > 16 else 16)))
    qtiles = -(-b // WIDE_QT)
    cluster = 2 if qtiles >= 2 else 1
    items = -(-nw // (WIDE_ROWS // WINDOW)) * -(-qtiles // cluster)
    return Config(arm, cluster, cluster * max(1, min(items, sms // cluster)))


def plan(queries: torch.Tensor, corpus: torch.Tensor, arm: Optional[str] = None) -> Config:
    """The configuration ``packed_window_scan_cuda`` launches for these
    operands on their card."""
    return _config(
        queries.shape[0], corpus.shape[0], queries.shape[1],
        corpus.dtype == torch.int8, _sm_count(corpus.device.index), arm,
    )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def packed_window_scan(
    queries: torch.Tensor,  # (B, d) scan dtype
    corpus: torch.Tensor,  # (N, d) scan dtype; N % 128 == 0
    lane_rank: Optional[torch.Tensor],  # (1, N) int32 (plain twins only)
    row_add: Optional[torch.Tensor] = None,  # (1, N) f32 (float domain)
    col_add: Optional[torch.Tensor] = None,  # (B, 1) f32 (float domain)
    alpha: float = 1.0,
    planes: int = 2,
) -> Tuple[torch.Tensor, ...]:
    """``planes`` (B, N/128) int32 packed planes (top-1[, top-2[,
    top-3]] keys per window) of ``alpha * Q X^T + col_add + row_add``
    (float) or of the clamped raw int32 dots (int8)."""
    int_domain = corpus.dtype == torch.int8
    if (queries.dtype == torch.int8) != int_domain:
        raise TypeError(
            f"packed_window_scan: queries {queries.dtype} vs corpus "
            f"{corpus.dtype}; both int8 or neither"
        )
    if planes not in ((1, 2) if int_domain else (1, 2, 3)):
        raise ValueError(
            f"planes must be in {{1, 2}} (int8) or {{1, 2, 3}} (float), "
            f"got {planes}"
        )
    if int_domain and (row_add is not None or col_add is not None or alpha != 1.0):
        raise ValueError("int domain packs raw dots; no affine terms")
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        from qrag_tpu_torch.ops import bounded_topk, window_scan

        if planes == 1:
            return (
                window_scan.packed_window_scan(
                    queries, corpus, lane_rank, row_add, col_add, alpha
                ),
            )
        if int_domain:
            return bounded_topk.packed_window_scan_top2_int(
                queries, corpus, lane_rank
            )
        twin = (
            bounded_topk.packed_window_scan_top3
            if planes == 3
            else bounded_topk.packed_window_scan_top2
        )
        return twin(queries, corpus, lane_rank, row_add, col_add, alpha)
    return packed_window_scan_cuda(queries, corpus, row_add, col_add, alpha, planes)


def packed_window_scan_cuda(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    row_add: Optional[torch.Tensor] = None,
    col_add: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
    planes: int = 2,
    arm: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """The planes from the kernel, or raises.  ``arm`` forces one arm of
    the kernel (to hold it against the other); it never selects the
    plain twin."""
    int_domain = corpus.dtype == torch.int8
    b, d = queries.shape
    n = corpus.shape[0]
    dev = corpus.device
    if dev.type != "cuda" or queries.device != dev:
        raise ValueError(
            f"packed_window_scan: queries on {queries.device}, corpus on "
            f"{dev}; the kernel needs both on one CUDA device"
        )
    dtype = torch.int8 if int_domain else torch.bfloat16
    if queries.dtype != dtype or corpus.dtype != dtype:
        raise TypeError(
            "packed_window_scan kernel takes bf16 or int8 queries and "
            f"corpus, got {queries.dtype} and {corpus.dtype}"
        )
    if corpus.ndim != 2 or corpus.shape[1] != d:
        raise ValueError(f"corpus {tuple(corpus.shape)} vs queries {(b, d)}")
    if b < 1 or n < WINDOW or n % WINDOW or d < 16 or d % 16:
        raise ValueError(
            f"kernel shapes: need B >= 1, N % 128 == 0, d % 16 == 0; got "
            f"B={b}, N={n}, d={d}"
        )
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("packed_window_scan kernel needs contiguous inputs")
    if queries.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("packed_window_scan kernel needs 16-byte aligned rows")
    if n >= 2**31 - WIDE_ROWS:
        raise ValueError(f"packed_window_scan kernel indexes rows in int32, got N={n}")
    nw = n // WINDOW
    cfg = plan(queries, corpus, arm)
    outs = [
        torch.empty((b, nw), dtype=torch.int32, device=dev)
        for _ in range(planes)
    ]
    if int_domain:
        _launch.launch(
            "qrag_window_scan_int8", dev, launches, ("int8", planes),
            queries.data_ptr(), corpus.data_ptr(), b, nw, d, planes,
            ARM_IDS[cfg.arm], cfg.cluster, cfg.grid,
            outs[0].data_ptr(), outs[-1].data_ptr(),
        )
    else:
        ra = _affine(row_add, n, dev, "row_add")
        ca = _affine(col_add, b, dev, "col_add")
        _launch.launch(
            "qrag_window_scan_bf16", dev, launches, ("bf16", planes),
            queries.data_ptr(), corpus.data_ptr(), ra.data_ptr(),
            ca.data_ptr(), b, nw, d, float(alpha), planes,
            ARM_IDS[cfg.arm], cfg.cluster, cfg.grid,
            outs[0].data_ptr(), outs[min(1, planes - 1)].data_ptr(),
            outs[-1].data_ptr(),
        )
    _launch.count(arm_launches, cfg.arm)
    return tuple(outs)


def _affine(t: Optional[torch.Tensor], size: int, dev, name: str) -> torch.Tensor:
    """(size,) contiguous, 16-byte aligned f32 on ``dev``: zeros for
    None, else the reference's (1, N) / (B, 1) operand flattened."""
    if t is None:
        return torch.zeros((size,), dtype=torch.float32, device=dev)
    if t.numel() != size or t.device != dev or t.dtype != torch.float32:
        raise ValueError(
            f"{name}: expected {size} f32 values on {dev}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )
    t = t.reshape(size).contiguous()
    return t.clone() if t.data_ptr() % 16 else t  # the wide arm copies row_add in bulk
