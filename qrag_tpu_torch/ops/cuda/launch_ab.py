"""A/B of the row gather's launch path and kernel between two checkouts
on one card.

    python -m qrag_tpu_torch.ops.cuda.launch_ab OLD_ROOT [NEW_ROOT]

Each root is a checkout of the repository (the new side defaults to
this one; the old side is e.g. the parent commit unpacked under
``build/``).  The roots are measured in turns old, new, new, old, each
in a process of its own that imports the ``qrag_tpu_torch`` of that
root and builds its kernels there.  Over 1,250,176 random f32 rows of
d=768 and M = 100, 6,400 and 102,400 random indices it times
``ops.gather_rows.gather_rows`` and ``torch.index_select`` three ways:
``host_us``, the host clock over 300 un-synchronised calls (the
wrapper's host path); ``ms``, 20 back-to-back calls between two CUDA
events (host and device together); ``device_ms``, 20 calls captured in
a CUDA graph and replayed three times (the device alone).  Needs one
CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

MEASURE = r"""
import json, time, torch
from qrag_tpu_torch.ops import gather_rows as tg

def host_us(fn, calls=300):
    fn(); torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us

def events_ms(fn, reps=20):
    fn(); torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps

def graph_ms(fn, reps=20, replays=3):
    fn(); torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(reps):
            fn()
    graph.replay(); torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record(); torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * replays)

gen = torch.Generator(device="cuda").manual_seed(5)
x = torch.randn((1_250_176, 768), generator=gen, device="cuda")
out = {}
for m in (100, 6400, 102400):
    idx = torch.randint(0, 1_000_000, (m,), generator=gen, device="cuda")
    assert torch.equal(tg.gather_rows(x, idx), x[idx])
    for name, fn in (("gather_rows", lambda: tg.gather_rows(x, idx)),
                     ("index_select", lambda: torch.index_select(x, 0, idx))):
        out[f"{name} M={m}"] = {
            "host_us": sorted(host_us(fn) for _ in range(3))[1],
            "ms": sorted(events_ms(fn) for _ in range(3))[1],
            "device_ms": graph_ms(fn),
        }
print("RESULT " + json.dumps(out))
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    old = Path(argv[0]).resolve()
    new = Path(argv[1]).resolve() if len(argv) > 1 else Path(__file__).resolve().parents[3]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for side, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        run = subprocess.run(
            [sys.executable, "-c", MEASURE], cwd=root, capture_output=True, text=True,
        )
        if run.returncode != 0:
            raise RuntimeError(f"{side} ({root}) failed:\n{run.stdout}\n{run.stderr}")
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")][-1]
        for name, row in json.loads(line[len("RESULT "):]).items():
            print(f"launch A/B [{card}] {side} {name}: host_us {row['host_us']:.2f}, "
                  f"ms {row['ms']:.4f}, device_ms {row['device_ms']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
