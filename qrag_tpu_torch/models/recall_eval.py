"""Bi-encoder training + recall@k evaluation (PyTorch port of
``qrag_tpu.models.recall_eval``).

Trains the bi-encoder (``models/bi_encoder.py``) with in-batch InfoNCE
on (query, chunk) pairs of the deterministic transcript corpus
(``pipeline/corpus_gen.py``), then measures recall@k of retrieval with
the trained embedder against the string-hash baseline on queries for
EPISODE-HELD-OUT chunks.  ``python -m qrag_tpu_torch.models.recall_eval
--device cuda`` runs the full-size version and prints JSON (``--device
cpu`` on a host without CUDA).  The optimizer is the reference's
``optax.adam``: Adam, no weight decay.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from qrag_tpu_torch.pipeline.corpus_gen import (
    Chunk,
    generate_corpus,
    make_query,
    split_by_episode,
    training_pairs,
)


@dataclass
class RecallEvalConfig:
    n_episodes: int = 48
    chunks_per_episode: int = 8
    holdout_frac: float = 0.25
    steps: int = 400
    batch: int = 64
    lr: float = 1e-3
    dim: int = 128  # tower width
    layers: int = 2
    heads: int = 4
    out_dim: int = 128
    max_len: int = 128
    k: int = 10
    queries_per_chunk: int = 2
    seed: int = 0


def _bi_config(cfg: RecallEvalConfig):
    from qrag_tpu_torch.models.bi_encoder import BiEncoderConfig
    from qrag_tpu_torch.models.cross_encoder import CrossEncoderConfig

    return BiEncoderConfig(
        tower=CrossEncoderConfig(
            dim=cfg.dim, n_heads=cfg.heads, n_layers=cfg.layers, max_len=cfg.max_len
        ),
        out_dim=cfg.out_dim,
    )


def _doc_batches(cfg: RecallEvalConfig, pairs: List[Tuple[str, str]]):
    """Per step, (queries, positive docs) with no chunk twice in a batch
    (two identical docs would make the in-batch labels ill-posed)."""
    rng = np.random.RandomState(cfg.seed + 7)
    by_doc: Dict[str, List[Tuple[str, str]]] = {}
    for q, d in pairs:
        by_doc.setdefault(d, []).append((q, d))
    docs = list(by_doc)
    eff_batch = min(cfg.batch, len(docs))
    for _ in range(cfg.steps):
        picks = rng.choice(len(docs), size=eff_batch, replace=False)
        qs, ds = [], []
        for p in picks:
            variants = by_doc[docs[p]]
            q, d = variants[rng.randint(len(variants))]
            qs.append(q)
            ds.append(d)
        yield qs, ds


def train_bi_encoder(cfg: RecallEvalConfig, pairs: List[Tuple[str, str]], device=None):
    """InfoNCE training loop; returns ``(TrainedEmbedder, loss trace)``,
    the trace ``(step, loss)`` every 50 steps and at the last."""
    import torch

    from qrag_tpu_torch.device import resolve_device
    from qrag_tpu_torch.models import bi_encoder as be
    from qrag_tpu_torch.models import cross_encoder as ce
    from qrag_tpu_torch.models.weights import ordered_parameters

    device = resolve_device(device)
    bi_cfg = _bi_config(cfg)
    model = ce.trainable(ce.load_module(be.BiEncoder(bi_cfg), be.init_params(bi_cfg, cfg.seed)),
                         device)
    optimizer = torch.optim.Adam(ordered_parameters(model, bi_cfg), lr=cfg.lr)
    step = be.make_train_step(model, optimizer, ce.default_dtype(device))
    losses = []
    for i, (qs, ds) in enumerate(_doc_batches(cfg, pairs)):
        qt, qm = be.tokenize_texts(qs, cfg.max_len)
        dt, dm = be.tokenize_texts(ds, cfg.max_len)
        loss = step(*ce.device_batch(device, qt, qm), *ce.device_batch(device, dt, dm))
        if i % 50 == 0 or i == cfg.steps - 1:
            losses.append((i, float(loss)))
    return be.TrainedEmbedder(bi_cfg, params=ce.module_params(model), device=device), losses


def recall_at_k(
    embedder,
    chunks: List[Chunk],
    eval_idx: Sequence[int],
    k: int,
    queries_per_chunk: int,
    seed: int = 11,
    device=None,
) -> float:
    """Index ALL chunks with ``embedder`` (exact top-k on ``device``),
    query for held-out chunks, score the fraction whose source chunk
    lands in the top-k."""
    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

    vecs = embedder([c.text for c in chunks])
    index = DeviceFlatIndex.from_numpy(
        np.asarray(vecs, np.float32), metric="l2", normalize=True,
        topk_mode="exact", device=device,
    )
    rng = np.random.RandomState(seed)
    queries, truth = [], []
    for ci in eval_idx:
        for _ in range(queries_per_chunk):
            queries.append(make_query(chunks[ci], rng))
            truth.append(ci)
    qv = np.asarray(embedder(queries), np.float32)
    res = index.search(qv, k=k)
    hits = sum(
        1 for qi, t in enumerate(truth) if t in set(int(i) for i in res.indices[qi])
    )
    return hits / len(truth)


def run_eval(
    cfg: Optional[RecallEvalConfig] = None,
    weights_dir: Optional[str] = None,
    device=None,
) -> Dict[str, object]:
    """Corpus -> split -> train -> recall@k of the trained embedder and
    of the hash embedder."""
    from qrag_tpu_torch.pipeline.embeddings import HashEmbedder

    cfg = cfg or RecallEvalConfig()
    chunks = generate_corpus(
        cfg.n_episodes, cfg.chunks_per_episode, seed=cfg.seed
    )
    train_idx, hold_idx = split_by_episode(
        chunks, cfg.holdout_frac, seed=cfg.seed + 1
    )
    pairs = training_pairs(
        chunks, train_idx, n_pairs=cfg.steps * cfg.batch, seed=cfg.seed + 2
    )
    t0 = time.time()
    trained, losses = train_bi_encoder(cfg, pairs, device=device)
    train_s = time.time() - t0
    out: Dict[str, object] = {
        "corpus_chunks": len(chunks),
        "held_out_chunks": len(hold_idx),
        "train_pairs": len(pairs),
        "steps": cfg.steps,
        "train_seconds": round(train_s, 1),
        "loss_trace": losses,
    }
    out["recall_at_k"] = cfg.k
    out["trained"] = recall_at_k(
        trained, chunks, hold_idx, cfg.k, cfg.queries_per_chunk, device=device
    )
    out["hash"] = recall_at_k(
        HashEmbedder(dim=cfg.out_dim), chunks, hold_idx, cfg.k,
        cfg.queries_per_chunk, device=device,
    )
    if weights_dir:
        trained.save(weights_dir)
        out["weights_dir"] = weights_dir
    return out


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="train + recall@k eval")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--episodes", type=int, default=48)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = RecallEvalConfig(
        steps=args.steps, n_episodes=args.episodes, batch=args.batch
    )
    print(json.dumps(run_eval(cfg, weights_dir=args.weights_dir, device=args.device), indent=2))


if __name__ == "__main__":
    main()
