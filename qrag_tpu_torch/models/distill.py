"""Distill the quantum fidelity scorer into the cross-encoder (PyTorch
port of ``qrag_tpu.models.distill``).

Teacher: ``|<psi_q|psi_d>|^2`` by the analytic product form
(``ops/statevector.batched_fidelity``) over a bi-encoder's embeddings
(the trained weights when given, else a fixed random init).  Student:
the cross-encoder, trained with the MSE between ``sigmoid(logit)`` and
the teacher (both in [0, 1]); with ``init_from`` the interaction head
warm-started from the trained bi-encoder.  The optimizer is the
reference's ``optax.adam``: Adam, no weight decay.

``python -m qrag_tpu_torch.models.distill --device cuda`` trains on
transcript-corpus pairs and prints held-out rank agreement (Spearman
and top-1) before and after.  The default random teacher draws from
``torch.Generator``, not jax.random: its scores are the port's own.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np


@dataclass
class DistillConfig:
    n_episodes: int = 16
    chunks_per_episode: int = 4
    docs_per_query: int = 8
    n_queries: int = 160
    holdout_frac: float = 0.25
    steps: int = 300
    batch: int = 32
    lr: float = 1e-3
    dim: int = 64
    layers: int = 2
    heads: int = 2
    max_len: int = 128
    n_qubits: int = 10
    teacher_weights: Optional[str] = None  # bi-encoder dir (else fixed init)
    # warm-start the student from this bi-encoder (interaction head;
    # geometry must match the artifact)
    init_from: Optional[str] = None
    n_experts: int = 4
    seed: int = 0


def default_teacher_embedder(n_qubits: int, weights_dir: Optional[str] = None, device=None):
    """The teacher's text embedder: the bi-encoder from ``weights_dir``
    when it exists, else a fixed random one (seed 42)."""
    from qrag_tpu_torch.models.bi_encoder import BiEncoderConfig, TrainedEmbedder
    from qrag_tpu_torch.models.cross_encoder import CrossEncoderConfig

    if weights_dir and os.path.isdir(weights_dir):
        return TrainedEmbedder(weights_dir=weights_dir, device=device)
    cfg = BiEncoderConfig(
        tower=CrossEncoderConfig(dim=64, n_heads=2, n_layers=1, max_len=128),
        out_dim=max(32, 2 * n_qubits),
    )
    return TrainedEmbedder(cfg, seed=42, device=device)


def teacher_fidelity(
    queries: Sequence[str],
    doc_lists: Sequence[Sequence[str]],
    n_qubits: int,
    embedder=None,
    device=None,
) -> np.ndarray:
    """Fidelity teacher over (query_i, doc_lists_i), flattened; the doc
    lists share a length.  The fidelity runs where the embedder runs
    (``device`` picks the default embedder's); only the result comes
    back to the host."""
    import torch

    from qrag_tpu_torch.ops.statevector import batched_fidelity

    embedder = embedder or default_teacher_embedder(n_qubits, device=device)
    d_per = len(doc_lists[0])
    flat_docs = [d for docs in doc_lists for d in docs]

    def vecs(texts):
        return torch.from_numpy(np.asarray(embedder(texts), np.float32)).to(embedder.device)

    q_vecs = vecs(list(queries))
    d_vecs = vecs(flat_docs).reshape(len(queries), d_per, -1)
    fid = batched_fidelity(q_vecs[:, None, :], d_vecs, n_qubits=n_qubits)
    return fid.cpu().numpy().astype(np.float32).reshape(-1)


def _make_pairs(cfg: DistillConfig):
    """(query, docs) items over the transcript corpus, train and
    held-out, split by episode."""
    from qrag_tpu_torch.pipeline.corpus_gen import (
        generate_corpus,
        make_query,
        split_by_episode,
    )

    chunks = generate_corpus(cfg.n_episodes, cfg.chunks_per_episode, cfg.seed)
    train_idx, hold_idx = split_by_episode(
        chunks, cfg.holdout_frac, seed=cfg.seed + 1
    )
    rng = np.random.RandomState(cfg.seed + 2)

    def build(idx_pool, n_queries):
        pool = np.asarray(list(idx_pool))
        items = []  # (query, [docs]) — docs_per_query per query
        for _ in range(n_queries):
            ci = int(pool[rng.randint(len(pool))])
            query = make_query(chunks[ci], rng)
            others = pool[rng.randint(0, len(pool), size=cfg.docs_per_query - 1)]
            docs = [chunks[ci].text] + [chunks[int(o)].text for o in others]
            items.append((query, docs))
        return items

    n_hold_q = max(8, cfg.n_queries // 4)
    return build(train_idx, cfg.n_queries), build(hold_idx, n_hold_q)


def _flatten_with_teacher(items, n_qubits, embedder):
    teacher = teacher_fidelity(
        [q for q, _ in items], [docs for _, docs in items], n_qubits,
        embedder=embedder,
    )
    qs, ds = [], []
    for query, docs in items:
        for doc in docs:
            qs.append(query)
            ds.append(doc)
    return qs, ds, teacher


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def _agreement(items, student_scores, teacher_scores, docs_per_query):
    """Per-query: does the student's best doc match the teacher's?"""
    hits, off = 0, 0
    for _query, docs in items:
        s = student_scores[off : off + len(docs)]
        t = teacher_scores[off : off + len(docs)]
        hits += int(np.argmax(s) == np.argmax(t))
        off += len(docs)
    return hits / len(items)


def mse_loss(model, tokens, mask, targets, dtype):
    """MSE between the student's sigmoid scores and the teacher's."""
    import torch

    return torch.mean((torch.sigmoid(model(tokens, mask, dtype)) - targets) ** 2)


def distill(cfg: Optional[DistillConfig] = None, device=None):
    """Returns ``(report, params, ce_cfg)``: the loss trace and held-out
    Spearman / top-1 agreement before and after, the student's
    parameters ({dotted name: array}) and its configuration."""
    import torch

    from qrag_tpu_torch.device import resolve_device
    from qrag_tpu_torch.models import cross_encoder as ce
    from qrag_tpu_torch.models.weights import ordered_parameters

    device = resolve_device(device)
    dtype = ce.default_dtype(device)
    cfg = cfg or DistillConfig()
    train_items, hold_items = _make_pairs(cfg)
    emb = default_teacher_embedder(cfg.n_qubits, cfg.teacher_weights, device=device)
    tq, td, t_teacher = _flatten_with_teacher(train_items, cfg.n_qubits, emb)
    hq, hd, h_teacher = _flatten_with_teacher(hold_items, cfg.n_qubits, emb)

    geometry = dict(dim=cfg.dim, n_heads=cfg.heads, n_layers=cfg.layers, max_len=cfg.max_len)
    if cfg.init_from:
        from qrag_tpu_torch.models.rerank_eval import resolve_init_from, warm_start_params

        ce_cfg = ce.CrossEncoderConfig(**geometry, n_experts=cfg.n_experts,
                                       head_type="interaction")
        init_dir = resolve_init_from(cfg.init_from)
        if init_dir is None:
            raise FileNotFoundError(f"init_from={cfg.init_from!r}: no such artifact")
        params = warm_start_params(ce_cfg, init_dir)
    else:
        ce_cfg = ce.CrossEncoderConfig(**geometry)
        params = ce.init_params(ce_cfg, cfg.seed)
    model = ce.trainable(
        ce.load_module(ce.CrossEncoder(ce_cfg, pos_rows=params["pos_emb"].shape[0]), params),
        device,
    )
    optimizer = torch.optim.Adam(ordered_parameters(model, ce_cfg), lr=cfg.lr)

    def tok(qs, ds):
        toks, masks = zip(*(ce.tokenize_pair(q, d, cfg.max_len) for q, d in zip(qs, ds)))
        return ce.device_batch(device, np.stack(toks), np.stack(masks))

    def score(tokens, mask):
        with torch.no_grad():
            return torch.sigmoid(model(tokens, mask, dtype)).cpu().numpy()

    h_tokens, h_mask = tok(hq, hd)
    before = score(h_tokens, h_mask)

    rng = np.random.RandomState(cfg.seed + 5)
    losses = []
    n = len(tq)
    for i in range(cfg.steps):
        picks = rng.randint(0, n, size=cfg.batch)
        tokens, mask = tok([tq[p] for p in picks], [td[p] for p in picks])
        targets = torch.from_numpy(t_teacher[picks]).to(device)
        loss = ce.apply_gradients(optimizer, mse_loss(model, tokens, mask, targets, dtype))
        if i % 50 == 0 or i == cfg.steps - 1:
            losses.append((i, float(loss)))

    after = score(h_tokens, h_mask)
    out: Dict[str, object] = {
        "loss_trace": losses,
        "spearman_before": round(_spearman(before, h_teacher), 4),
        "spearman_after": round(_spearman(after, h_teacher), 4),
        "top1_agreement_before": round(
            _agreement(hold_items, before, h_teacher, cfg.docs_per_query), 4
        ),
        "top1_agreement_after": round(
            _agreement(hold_items, after, h_teacher, cfg.docs_per_query), 4
        ),
        "held_out_pairs": len(hq),
    }
    return out, ce.module_params(model), ce_cfg


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="fidelity -> cross-encoder distillation")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out", default=None, help="save student weights dir")
    p.add_argument("--episodes", type=int, default=16)
    p.add_argument("--chunks-per-episode", type=int, default=4)
    p.add_argument("--queries", type=int, default=160)
    p.add_argument("--docs-per-query", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument(
        "--teacher-weights", default=None,
        help="trained bi-encoder dir (e.g. artifacts/bi_encoder)",
    )
    p.add_argument(
        "--init-from", default=None,
        help="warm-start the student tower from this bi-encoder dir "
        "(interaction head; its geometry must match --dim/--heads/--layers)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    out, params, ce_cfg = distill(
        DistillConfig(
            steps=args.steps,
            n_episodes=args.episodes,
            chunks_per_episode=args.chunks_per_episode,
            n_queries=args.queries,
            docs_per_query=args.docs_per_query,
            batch=args.batch,
            lr=args.lr,
            dim=args.dim,
            layers=args.layers,
            heads=args.heads,
            max_len=args.max_len,
            teacher_weights=args.teacher_weights,
            init_from=args.init_from,
        ),
        device=args.device,
    )
    if args.out:
        from qrag_tpu_torch.models.cross_encoder import CrossEncoderScorer

        CrossEncoderScorer(ce_cfg, params=params, device=args.device).save(args.out)
        out["weights_dir"] = args.out
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
