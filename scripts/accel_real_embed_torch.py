"""Clustered-accelerator evidence on REAL learned-embedding geometry,
on the PyTorch/CUDA port (the counterpart of
``scripts/accel_real_embed.py``).

Embeds a generated transcript corpus with the TRAINED bi-encoder
artifact and measures the cluster-pruned exact accelerator's
exactness (hits identical to the f32 exact top-10) and its
certificate-tier usage (escalated and fallback batches of 8 queries).

    python scripts/accel_real_embed_torch.py [--episodes 768] [--device cuda|cpu]

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


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--episodes", type=int, default=768)
    p.add_argument("--group-rows", type=int, default=128)
    p.add_argument("--queries", type=int, default=64)
    p.add_argument("--weights", default="artifacts/bi_encoder")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from qrag_tpu_torch.models.bi_encoder import TrainedEmbedder
    from qrag_tpu_torch.ops.cluster_topk import (
        build_clustered_groups,
        cluster_pruned_topk,
    )
    from qrag_tpu_torch.ops.topk import _goodness, top_k
    from qrag_tpu_torch.pipeline.corpus_gen import generate_corpus, make_query

    chunks = generate_corpus(
        n_episodes=args.episodes, chunks_per_episode=8, seed=3
    )
    emb = TrainedEmbedder(weights_dir=args.weights, device=device)
    t0 = time.time()
    X = emb([c.text for c in chunks])
    print(f"embedded {X.shape} on {device} in {time.time()-t0:.0f}s", flush=True)

    xt = torch.from_numpy(X).to(device)
    groups = build_clustered_groups(
        xt, group_rows=args.group_rows, kmeans_iters=6
    )
    radii = groups.radii.cpu().numpy()
    print(
        f"groups G={groups.centroids.shape[0]} radii mean/p90 "
        f"{radii.mean():.3f}/{np.quantile(radii, 0.9):.3f}",
        flush=True,
    )

    rng = np.random.RandomState(0)
    qs = [
        make_query(chunks[i], rng)
        for i in rng.randint(0, len(chunks), args.queries)
    ]
    Q = emb(qs)
    fb_n = esc_n = ok_n = total = 0
    for i in range(0, args.queries, 8):
        q = torch.from_numpy(Q[i : i + 8]).to(device)
        vals, idx, fb, esc = cluster_pruned_topk(q, groups, 10)
        _, oi = top_k(_goodness(q, xt, "l2", None, None), 10)
        ok_n += int((idx == oi).sum())
        total += idx.numel()
        fb_n += int(fb)
        esc_n += int(esc)
    batches = -(-args.queries // 8)
    print(
        f"real-embedding accel: {ok_n}/{total} oracle-identical hits, "
        f"fallback batches {fb_n}/{batches}, escalated {esc_n}/{batches}",
        flush=True,
    )


if __name__ == "__main__":
    main()
