"""A/B timing of two versions of the packed window-scan kernels on one card.

    python -m qrag_tpu_torch.ops.cuda.scan_ab OLD_CSRC_DIR [NEW_CSRC_DIR]

Builds each directory's ``*.cu`` as ``_build`` does (into
``build/qrag_tpu_torch/ab/``), loads both libraries, holds the new
planes against the old ones, and times both domains — bf16 planes 2 and
3 with the l2 affine terms, int8 planes 1 and 2 — at B=1024, 64 and 1
over 1,250,176 random rows of d=768, in turns old, new, new, old (CUDA
events, 20 to 400 launches per turn, about a quarter of a second).  The
int8 planes must be bit-equal.  The float planes are held to the plane
contract (``plane_contract`` below): two tensor-core accumulation orders
may round a score to either side of a truncation boundary, so
bit-equality is not the float domain's contract.  A side whose library has the entry points of before the arms
is called through those; a side with arms launches what ``plan`` picks.
The new side defaults to this checkout's ``csrc``.  Needs one CUDA
device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from qrag_tpu_torch.ops.cuda import _build, fused_scan

N, D = 1_250_176, 768
WINDOW = 128


def plane_contract(got, ref, q, x, alpha, ra, ca):
    """Float planes ``got`` against reference planes ``ref`` (the plain
    twin's, or another kernel's) of the same operands — q (B, d) and x
    (N, d) bf16, ra (1, N) f32, ca (B, 1) f32 or None.  The contract:
    upper value bounds within rtol 1e-4 / atol 1e-3; lanes equal
    wherever the truncated keys agree, except at a truncated tie (two
    rows of one window within one quantum, where accumulation drift
    picks either): there the row that ``got`` names must score,
    re-evaluated in f32, inside ``ref``'s value bounds widened by that
    tolerance.  Raises AssertionError; returns (max |upper-bound
    difference|, keys equal, keys, lanes differing at truncated ties)."""
    from qrag_tpu_torch.ops import bounded_topk as bt

    err, n_same, n_all, ties = 0.0, 0, 0, 0
    for g_, r in zip(got, ref):
        _, hi_g = bt.plane_value_bounds(g_)
        lo_r, hi_r = bt.plane_value_bounds(r)
        if not torch.allclose(hi_g, hi_r, rtol=1e-4, atol=1e-3):
            raise AssertionError("plane value bounds outside rtol 1e-4/atol 1e-3")
        err = max(err, (hi_g - hi_r).abs().max().item())
        same = (g_ & ~127) == (r & ~127)
        n_same += int(same.sum())
        n_all += same.numel()
        bad = same & ((g_ & 127) != (r & 127))
        if not bool(bad.any()):
            continue
        bi, wi = torch.nonzero(bad, as_tuple=True)
        rows = wi * WINDOW + (127 - (g_[bi, wi] & 127))
        s = alpha * (q[bi].float() * x[rows].float()).sum(1) + ra[0, rows]
        if ca is not None:
            s = s + ca[bi, 0]
        lo, hi = lo_r[bi, wi], hi_r[bi, wi]
        tol = 1e-4 * hi.abs() + 1e-3
        if not bool(((s >= lo - tol) & (s <= hi + tol)).all()):
            raise AssertionError("a lane differs where keys agree beyond a trunc tie")
        ties += int(bad.sum())
    return err, n_same, n_all, ties


def _scan(lib, q, x, ra, ca, planes):
    """One launch through ``lib``'s own entry point."""
    b, nw, d = q.shape[0], x.shape[0] // WINDOW, q.shape[1]
    int8 = x.dtype == torch.int8
    outs = [torch.empty((b, nw), dtype=torch.int32, device=q.device) for _ in range(3)]
    o = [t.data_ptr() for t in outs]
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "qrag_window_scan_bf16"):
        cfg = fused_scan.plan(q, x)
        arm = (fused_scan.ARM_IDS[cfg.arm], cfg.cluster, cfg.grid)
        if int8:
            err = lib.qrag_window_scan_int8(
                q.data_ptr(), x.data_ptr(), b, nw, d, planes, *arm, o[0], o[1], stream)
        else:
            err = lib.qrag_window_scan_bf16(
                q.data_ptr(), x.data_ptr(), ra.data_ptr(), ca.data_ptr(), b, nw, d, 2.0,
                planes, *arm, o[0], o[1], o[2], stream)
    elif int8:
        err = lib.qrag_packed_window_scan_int8(
            q.data_ptr(), x.data_ptr(), b, nw, d, planes, o[0], o[1], stream)
    else:
        err = lib.qrag_packed_window_scan(
            q.data_ptr(), x.data_ptr(), ra.data_ptr(), ca.data_ptr(), b, nw, d, 2.0, planes,
            o[0], o[1], o[2], stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return outs[:planes]


def _ms(fn):
    """ms per call over a turn of about a quarter of a second (20 to 400
    launches): a short turn times the card's clocks ramping."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    reps = max(20, min(400, int(250 / max(e0.elapsed_time(e1), 1e-3))))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dirs = [Path(argv[0]), Path(argv[1]) if len(argv) > 1 else _build.CSRC]
    root = _build.BUILD_ROOT / "ab"
    old, new = (_build.bind(_build.build_library(d, root)[0]) for d in dirs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    xf = torch.randn((N, D), generator=gen, device="cuda")
    xf = xf / xf.norm(dim=1, keepdim=True)
    x8 = (xf * 127 * 8).round().clamp(-127, 127).to(torch.int8)
    x = xf.bfloat16()
    del xf
    ra = -(x.float() ** 2).sum(1)
    for b in (1024, 64, 1):
        qf = torch.randn((b, D), generator=gen, device="cuda")
        qf = qf / qf.norm(dim=1, keepdim=True)
        q, q8 = qf.bfloat16(), (qf * 127 * 8).round().clamp(-127, 127).to(torch.int8)
        ca = -(q.float() ** 2).sum(1)
        for domain, qq, xx, all_planes in (("bf16", q, x, (2, 3)), ("int8", q8, x8, (1, 2))):
            for planes in all_planes:
                a = _scan(old, qq, xx, ra, ca, planes)
                c = _scan(new, qq, xx, ra, ca, planes)
                torch.cuda.synchronize()
                if domain == "int8":
                    if not all(torch.equal(u, v) for u, v in zip(a, c)):
                        raise AssertionError(f"int8 B={b} planes={planes}: planes differ")
                    held = "planes bit-equal"
                else:
                    err, same, keys, ties = plane_contract(
                        c, a, q, x, 2.0, ra[None, :], ca[:, None])
                    held = (f"plane contract holds (max |hi err| {err:.3g}, trunc keys equal "
                            f"{same / keys:.4f}, lanes at truncated ties {ties})")
                turns = [_ms(lambda: _scan(lib, qq, xx, ra, ca, planes))
                         for lib in (old, new, new, old)]
                print(f"scan A/B [{card}] {domain} B={b} N={N} d={D} planes={planes}: "
                      f"old {turns[0]:.4f}/{turns[3]:.4f} ms, new {turns[1]:.4f}/"
                      f"{turns[2]:.4f} ms (old, new, new, old); {held}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
