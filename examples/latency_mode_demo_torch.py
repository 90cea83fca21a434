"""Small-batch latency serving with the cluster-pruned exact
accelerator (``qrag_tpu_torch/ops/cluster_topk.py``), on the
PyTorch/CUDA port (the counterpart of ``examples/latency_mode_demo.py``).

Scenario: an interactive RAG service answering ONE query at a time
over a large clustered embedding corpus.  The flat scan reads the
whole corpus per batch (memory-bound at small B); the accelerator
certifies which contiguous row groups can contain top-k rows and
reads only those — provably exact, same results, fraction of the
reads.

Run: python examples/latency_mode_demo_torch.py [--device cuda|cpu]
(the device defaults to CUDA and raises without it)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qrag_tpu_torch.device import resolve_device  # noqa: E402
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex  # noqa: E402

N, D, CENTERS = 60_000, 256, 12


def make_clustered_corpus(rng):
    """Mixture of Gaussians on the unit sphere — the geometry real
    embedding corpora have (uniform random data defeats any pruning
    structure by construction; the accelerator then self-corrects
    through its exact fallback)."""
    centers = rng.normal(size=(CENTERS, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, CENTERS, N)
    x = centers[which] + (0.25 / np.sqrt(D)) * rng.normal(
        size=(N, D)
    ).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    x = make_clustered_corpus(rng)
    meta = [f"episode_{i // 8}/chunk_{i % 8}" for i in range(N)]

    flat = DeviceFlatIndex.from_numpy(x, metric="l2", metadata=meta, device=device)
    accel = DeviceFlatIndex.from_numpy(
        x,
        metric="l2",
        metadata=meta,
        small_batch_accel="clustered",
        cluster_group_rows=256,
        accel_max_batch=8,
        device=device,
    )
    t0 = time.time()
    accel.build_clustered()  # eager (engine.warmup does this in serving)
    print(f"clustered structure built in {time.time() - t0:.1f}s")

    q = x[rng.integers(0, N, 4)] + 0.01 * rng.normal(size=(4, D)).astype(
        np.float32
    )

    r_flat = flat.search(q, k=5)
    r_accel = accel.search(q, k=5)
    assert np.array_equal(r_flat.indices, r_accel.indices), "must be exact"
    print("accelerated results identical to the flat scan:")
    for i, s, m in r_accel.top(0):
        print(f"  idx={i:6d}  dist={s:.4f}  {m}")
    print(
        f"certificate events: escalations={accel.cluster_escalations}, "
        f"fallbacks={accel.cluster_fallbacks}"
    )

    def best_of(f, reps=5):
        best = float("inf")
        for _ in range(reps):
            t0 = time.time()
            f()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            best = min(best, time.time() - t0)
        return best

    t_flat = best_of(lambda: flat.search(q[:1], k=5))
    t_accel = best_of(lambda: accel.search(q[:1], k=5))
    print(
        f"single-query search on {device}: flat {t_flat * 1e3:.2f} ms vs "
        f"clustered {t_accel * 1e3:.2f} ms ({t_flat / t_accel:.1f}x) "
        "(dispatch overhead included; the gap widens with corpus size)"
    )


if __name__ == "__main__":
    main()
