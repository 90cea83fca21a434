"""Train the cross-encoder reranker:
``python -m qrag_tpu_torch.models.train_cli`` (PyTorch port of
``qrag_tpu.models.train_cli``).

Saves the weights where the classical reranker's "cross-encoder" method
loads them (``model_cache_dir/<model_name>/params.npz`` + config.json,
the JAX package's format) and a resumable checkpoint at ``<out>.ckpt``
(``models/checkpoint.py``: npz, not orbax).  Data: JSONL of
``{"query": ..., "doc": ..., "label": 0|1}`` via --data, or the
synthetic relevance task.  Training runs on one device, ``--device
cuda`` unless ``--device cpu`` is given; the reference's mesh comes
with ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Iterator, List, Tuple

import numpy as np


def _jsonl_batches(
    path: str, batch: int, max_len: int, rng: np.random.RandomState
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    from qrag_tpu_torch.models.cross_encoder import tokenize_pair

    rows: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        raise ValueError(f"{path}: no training rows")
    while True:
        picks = rng.choice(len(rows), size=batch)
        toks, masks, labels = [], [], []
        for i in picks:
            r = rows[i]
            t, m = tokenize_pair(str(r["query"]), str(r["doc"]), max_len)
            toks.append(t)
            masks.append(m)
            labels.append(float(r["label"]))
        yield np.stack(toks), np.stack(masks), np.asarray(labels, np.float32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="train the qrag cross-encoder")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--experts", type=int, default=4)
    parser.add_argument("--max-len", type=int, default=128)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--data", default=None, help="JSONL {query,doc,label}")
    parser.add_argument(
        "--out", default="cross_encoder/qrag-cross-encoder-tiny"
    )
    parser.add_argument("--resume", default=None, help="checkpoint dir")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from qrag_tpu_torch.models.checkpoint import load_train_state, save_train_state
    from qrag_tpu_torch.models.cross_encoder import (
        CrossEncoderConfig,
        CrossEncoderScorer,
        default_dtype,
        module_params,
    )
    from qrag_tpu_torch.parallel.train import make_trainer, synthetic_batch

    cfg = CrossEncoderConfig(
        dim=args.dim,
        n_heads=args.heads,
        n_layers=args.layers,
        n_experts=args.experts,
        max_len=args.max_len,
    )
    model, optimizer, step_fn = make_trainer(
        cfg, learning_rate=args.lr, seed=args.seed, device=args.device, remat=args.remat
    )
    device = model.tok_emb.device
    dtype = default_dtype(device)
    print(f"device: {device} (single device)")
    start_step = 0
    if args.resume:
        start_step, _ = load_train_state(args.resume, model, optimizer, cfg)
        print(f"resumed from {args.resume} at step {start_step}")

    rng = np.random.RandomState(args.seed)
    data_iter = (
        _jsonl_batches(args.data, args.batch, cfg.max_len, rng)
        if args.data
        else None
    )
    t0 = time.time()
    loss = float("nan")
    for step in range(start_step, start_step + args.steps):
        if data_iter is not None:
            toks, masks, labels = next(data_iter)
        else:
            toks, masks, labels = synthetic_batch(rng, args.batch, cfg.max_len)
        loss = step_fn(toks, masks, labels)
        if (step + 1) % 20 == 0 or step == start_step:
            print(
                f"step {step + 1}: loss {float(loss):.4f} "
                f"({(time.time() - t0):.1f}s)"
            )

    final_step = start_step + args.steps
    # inference weights where ClassicalReranker's cross-encoder method
    # looks for them
    scorer = CrossEncoderScorer(cfg, params=module_params(model), device=device)
    scorer.save(args.out)
    # resumable training state
    save_train_state(args.out + ".ckpt", model, optimizer, final_step, cfg, dtype, args.remat)
    print(
        f"trained to step {final_step} (loss {float(loss):.4f}); "
        f"weights -> {args.out}, checkpoint -> {args.out}.ckpt"
    )


if __name__ == "__main__":
    main()
