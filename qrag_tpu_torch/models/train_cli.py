"""Train the cross-encoder reranker:
``python -m qrag_tpu_torch.models.train_cli`` (PyTorch port of
``qrag_tpu.models.train_cli``).

Saves the weights where the classical reranker's "cross-encoder" method
loads them (``model_cache_dir/<model_name>/params.npz`` + config.json,
the JAX package's format) and a resumable checkpoint at ``<out>.ckpt``
(``models/checkpoint.py``: npz, not orbax).  Data: JSONL of
``{"query": ..., "doc": ..., "label": 0|1}`` via --data, or the
synthetic relevance task.  It trains DP x TP/EP over a data x model
mesh, as the reference does: model = gcd(processes, experts or heads),
data = the rest; one process is a 1 x 1 mesh on ``--device`` (``cuda``
unless ``cpu`` is given).  Several processes come from ``torchrun``
(``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``, read by
``distributed_init("env://")``: NCCL on CUDA, gloo on the CPU).  Rank 0
gathers the sharded parameters and Adam state and alone writes the
weights and the checkpoint, in the one-device formats.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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

    from qrag_tpu_torch.models.cross_encoder import CrossEncoderConfig
    from qrag_tpu_torch.parallel.mesh import process_index, shutdown

    cfg = CrossEncoderConfig(
        dim=args.dim,
        n_heads=args.heads,
        n_layers=args.layers,
        n_experts=args.experts,
        max_len=args.max_len,
    )
    model, optimizer, step_fn, start_step = _trainer(cfg, args)
    lead = process_index() == 0

    rng = np.random.RandomState(args.seed)
    data_iter = (
        _jsonl_batches(args.data, args.batch, cfg.max_len, rng)
        if args.data
        else None
    )
    from qrag_tpu_torch.parallel.train import synthetic_batch

    t0 = time.time()
    loss = float("nan")
    for step in range(start_step, start_step + args.steps):
        if data_iter is not None:
            toks, masks, labels = next(data_iter)
        else:
            toks, masks, labels = synthetic_batch(rng, args.batch, cfg.max_len)
        loss = step_fn(toks, masks, labels)
        if lead and ((step + 1) % 20 == 0 or step == start_step):
            print(
                f"step {step + 1}: loss {float(loss):.4f} "
                f"({(time.time() - t0):.1f}s)"
            )

    final_step = start_step + args.steps
    _save(cfg, args, model, optimizer, final_step, lead)
    if lead:
        print(
            f"trained to step {final_step} (loss {float(loss):.4f}); "
            f"weights -> {args.out}, checkpoint -> {args.out}.ckpt"
        )
    shutdown()


def _trainer(cfg, args):
    """(model, optimizer, step_fn, start step) of this rank, DP x TP/EP
    over every process (the reference's mesh rule; 1 x 1 in one
    process)."""
    from qrag_tpu_torch.config import MeshConfig
    from qrag_tpu_torch.parallel.mesh import distributed_init, make_mesh, process_index
    from qrag_tpu_torch.parallel.train import load_sharded_state, make_sharded_trainer

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        distributed_init("env://", device=args.device)
    # the model axis must divide the sharded dims (experts, or attention
    # heads / FFN hidden); the rest goes on "data"
    mp = math.gcd(world, args.experts if args.experts > 0 else args.heads)
    mesh = make_mesh(MeshConfig(data_parallel=world // mp, model_parallel=mp), device=args.device)
    model, optimizer, step_fn = make_sharded_trainer(
        cfg, mesh, learning_rate=args.lr, seed=args.seed, remat=args.remat
    )
    lead = process_index() == 0
    if lead:
        where = " (single device)" if world == 1 else ""
        print(f"mesh: data={world // mp} x model={mp} over {world} processes; "
              f"device: {model.tok_emb.device}{where}")
    start_step = 0
    if args.resume:
        start_step, params, mu, nu, count = _read_state(args.resume, cfg)
        load_sharded_state(model, optimizer, cfg, mesh, params, mu, nu, count)
        if lead:
            print(f"resumed from {args.resume} at step {start_step}")
    return model, optimizer, step_fn, start_step


def _full_trainer(cfg, lr):
    """A full model and AdamW on the host (the checkpoint's form)."""
    import torch

    from qrag_tpu_torch.models import cross_encoder as ce
    from qrag_tpu_torch.models.weights import ordered_parameters

    model = ce.trainable(ce.CrossEncoder(cfg), "cpu")
    optimizer = torch.optim.AdamW(ordered_parameters(model, cfg), lr=lr,
                                  weight_decay=ce.ADAMW_DECAY)
    return model, optimizer


def _read_state(path, cfg):
    """A checkpoint as full arrays: (step, params, mu, nu, count)."""
    from qrag_tpu_torch.models.checkpoint import load_train_state
    from qrag_tpu_torch.models.cross_encoder import module_params
    from qrag_tpu_torch.models.weights import param_paths

    model, optimizer = _full_trainer(cfg, 0.0)
    step, _ = load_train_state(path, model, optimizer, cfg)
    state = optimizer.state_dict()["state"]
    names = param_paths(cfg)
    mu = {n: state[k]["exp_avg"].numpy() for k, n in enumerate(names)}
    nu = {n: state[k]["exp_avg_sq"].numpy() for k, n in enumerate(names)}
    return step, module_params(model), mu, nu, int(state[0]["step"])


def _save(cfg, args, model, optimizer, step, lead):
    """Every rank gathers its blocks (a collective over "model"); rank 0
    writes the full state: the inference weights where
    ``ClassicalReranker``'s cross-encoder method looks for them, and the
    resumable checkpoint."""
    from qrag_tpu_torch.models.checkpoint import save_train_state
    from qrag_tpu_torch.models.cross_encoder import CrossEncoderScorer, default_dtype, load_module
    from qrag_tpu_torch.models.weights import adam_state, load_adam_state, param_paths
    from qrag_tpu_torch.parallel.train import gather_train_state

    params, mu, nu, count = gather_train_state(model, optimizer, cfg)
    if not lead:
        return
    full, opt = _full_trainer(cfg, args.lr)
    load_module(full, params)
    names = param_paths(cfg)
    if count:
        load_adam_state(opt, adam_state([mu[n] for n in names], [nu[n] for n in names], count))
    CrossEncoderScorer(cfg, params=params, device="cpu").save(args.out)
    save_train_state(args.out + ".ckpt", full, opt, step, cfg, default_dtype(model.tok_emb.device),
                     args.remat)


if __name__ == "__main__":
    main()
