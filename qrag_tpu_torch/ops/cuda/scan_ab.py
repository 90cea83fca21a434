"""A/B timing of two versions of the scan kernel's float arm on one card.

    python -m qrag_tpu_torch.ops.cuda.scan_ab OLD_CSRC_DIR [NEW_CSRC_DIR]

Builds each directory's ``*.cu`` as ``_build`` does (into
``build/qrag_tpu_torch/ab/``), loads both libraries, checks that they
give equal planes, and times planes 2 and 3 at B=1 and B=1024 over
1,250,176 random unit bf16 rows of d=768 with the l2 affine terms, in
turns old, new, new, old (CUDA events, 20 launches per turn).  The new
side defaults to this checkout's ``csrc``.  Needs one CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from qrag_tpu_torch.ops.cuda import _build

N, D = 1_250_176, 768


def _scan(lib, q, x, ra, ca, planes):
    b, nw = q.shape[0], x.shape[0] // 128
    outs = [torch.empty((b, nw), dtype=torch.int32, device=q.device) for _ in range(3)]
    err = lib.qrag_packed_window_scan(
        q.data_ptr(), x.data_ptr(), ra.data_ptr(), ca.data_ptr(), b, nw,
        q.shape[1], 2.0, planes, outs[0].data_ptr(), outs[1].data_ptr(),
        outs[2].data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return outs[:planes]


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    x = torch.randn((N, D), generator=gen, device="cuda")
    x = (x / x.norm(dim=1, keepdim=True)).bfloat16()
    ra = -(x.float() ** 2).sum(1)
    for b in (1024, 1):
        q = torch.randn((b, D), generator=gen, device="cuda")
        q = (q / q.norm(dim=1, keepdim=True)).bfloat16()
        ca = -(q.float() ** 2).sum(1)
        for planes in (2, 3):
            a = _scan(old, q, x, ra, ca, planes)
            c = _scan(new, q, x, ra, ca, planes)
            if not all(torch.equal(u, v) for u, v in zip(a, c)):
                raise AssertionError(f"B={b} planes={planes}: old and new planes differ")
            turns = []
            for lib in (old, new, new, old):
                turns.append(_ms(lambda: _scan(lib, q, x, ra, ca, planes)))
            print(f"scan A/B [{card}] bf16 B={b} N={N} d={D} planes={planes}: "
                  f"old {turns[0]:.4f}/{turns[3]:.4f} ms, new {turns[1]:.4f}/"
                  f"{turns[2]:.4f} ms (old, new, new, old); planes equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
