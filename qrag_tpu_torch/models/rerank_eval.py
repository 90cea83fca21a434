"""Cross-encoder rerank-quality training + evaluation (PyTorch port of
``qrag_tpu.models.rerank_eval``).

Protocol, as the reference's: the deterministic transcript corpus
(``pipeline/corpus_gen.py``) split by EPISODE; the interaction-head
cross-encoder warm-started from the trained bi-encoder
(``warm_start_params``: the tower verbatim, ``proj`` as ``iproj``,
closed gates, a zero CLS head, so step 0 scores are the bi-encoder's
cosine); an in-batch listwise fine-tune (every (query_i, doc_j) pair of
a group of Q chunks, softmax-CE on the diagonal, hard same-topic and
mixed groups in turn, optionally plus an MSE to the fidelity teacher
over the same pair matrix); then top-1 / MRR / nDCG@10 over candidate
sets of held-out chunks, against the cosine scorers, with the
fresh-corpus ship rule.  The optimizer is the reference's
``optax.adamw(lr, weight_decay=1e-4)`` (``cross_encoder.ADAMW_DECAY``).

``python -m qrag_tpu_torch.models.rerank_eval --device cuda`` runs it
and prints JSON; ``--weights-dir`` saves the shipped scorer where
``ClassicalReranker(method="cross-encoder")`` loads it.  Random inits
come from ``torch.Generator`` and so differ from jax.random's: the
"cross_encoder_untrained" floor is the port's own number.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from qrag_tpu_torch.pipeline.corpus_gen import (
    Chunk,
    generate_corpus,
    make_query,
    split_by_episode,
)

logger = logging.getLogger(__name__)


def resolve_init_from(path: Optional[str]) -> Optional[str]:
    """The warm-start artifact directory as an absolute path: tried
    against the working directory, then (relative paths) the repository
    root.  A configured path that does not exist logs a warning and
    gives None: the run is from scratch and says so."""
    if not path:
        return None
    candidates = [path]
    if not os.path.isabs(path):
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        candidates.append(os.path.join(repo_root, path))
    for cand in candidates:
        if os.path.isdir(cand):
            return os.path.abspath(cand)
    logger.warning(
        "init_from=%r configured but no such directory (tried %s): "
        "training FROM SCRATCH — expect drastically worse rerank "
        "quality than a warm-started run",
        path,
        candidates,
    )
    return None


@dataclass
class RerankEvalConfig:
    n_episodes: int = 48
    chunks_per_episode: int = 8
    holdout_frac: float = 0.25
    steps: int = 600
    batch: int = 16  # in-batch group size Q (Q^2 pair forwards/step)
    lr: float = 3e-4
    dim: int = 128
    layers: int = 2
    heads: int = 4
    n_experts: int = 4  # must match the warm-start tower when used
    max_len: int = 224  # fits full query+doc; segment pos stay < 128
    candidates: int = 32  # rerank candidate-set size per eval query
    queries_per_chunk: int = 2
    seed: int = 0
    # warm start from the shipped bi-encoder (same tower); None = from
    # scratch
    init_from: Optional[str] = "artifacts/bi_encoder"
    # weight of the auxiliary MSE between sigmoid(logit) and the
    # fidelity teacher over the same pair matrix (0 = off)
    distill_weight: float = 0.0
    distill_qubits: int = 10
    # every `curve_every` steps, score val and held-out subsamples of
    # `curve_cases` cases (0 = off)
    curve_every: int = 0
    curve_cases: int = 96
    # fresh-seed validation corpus, as a fraction of n_episodes: the
    # ship rule's fold (0 = the legacy train-slice fold)
    val_episode_frac: float = 0.25
    # fresh-seed episodes appended to the fine-tune pool only
    extra_train_episodes: int = 0


def _make_cfg(cfg: RerankEvalConfig):
    from qrag_tpu_torch.models.cross_encoder import CrossEncoderConfig

    return CrossEncoderConfig(
        dim=cfg.dim,
        n_heads=cfg.heads,
        n_layers=cfg.layers,
        max_len=cfg.max_len,
        n_experts=cfg.n_experts,
        head_type="interaction",
    )


def warm_start_params(ce_cfg, weights_dir: str) -> Dict[str, np.ndarray]:
    """The trained bi-encoder's weights renamed onto the cross-encoder:
    the tower (embeddings, blocks, final LN) verbatim, ``proj`` as
    ``iproj``, every ``xgate`` zero (closed) and a zero CLS head.
    Deterministic: no random draw."""
    from qrag_tpu_torch.models.bi_encoder import _load_config
    from qrag_tpu_torch.models.weights import params_from_npz

    bi_cfg = _load_config(weights_dir)
    t = bi_cfg.tower
    if (t.dim, t.n_heads, t.n_layers, t.n_experts) != (
        ce_cfg.dim, ce_cfg.n_heads, ce_cfg.n_layers, ce_cfg.n_experts
    ):
        raise ValueError(
            f"warm-start tower mismatch: artifact {t} vs requested {ce_cfg}"
        )
    if bi_cfg.out_dim != ce_cfg.dim:
        raise ValueError(
            "interaction iproj needs out_dim == dim to inherit proj "
            f"(artifact out_dim={bi_cfg.out_dim}, dim={ce_cfg.dim})"
        )
    with np.load(os.path.join(weights_dir, "bi_encoder.npz")) as data:
        bi = params_from_npz(data, bi_cfg)
    params = {name: a for name, a in bi.items() if not name.startswith("proj.")}
    params["iproj.w"], params["iproj.b"] = bi["proj.w"], bi["proj.b"]
    params["head.w"] = np.zeros((ce_cfg.dim, 1), np.float32)
    params["head.b"] = np.zeros((1,), np.float32)
    for i in range(ce_cfg.n_layers):
        params[f"layers.{i}.xgate"] = np.zeros((), np.float32)
    return params


# ----------------------------------------------------------------- training


def listwise_loss(model, tokens, mask, teacher, dtype, distill_weight: float = 0.0):
    """Softmax-CE on the diagonal of the (Q, Q) logits of every
    (query_i, doc_j) pair, plus ``distill_weight`` times the MSE between
    their sigmoids and ``teacher`` (Q, Q)."""
    import torch

    qn, m, tl = tokens.shape
    logits = model(tokens.reshape(qn * m, tl), mask.reshape(qn * m, tl), dtype).reshape(qn, m)
    loss = -torch.log_softmax(logits, dim=1).diagonal().mean()
    if distill_weight > 0.0:
        loss = loss + distill_weight * torch.mean((torch.sigmoid(logits) - teacher) ** 2)
    return loss


def make_listwise_step(model, optimizer, dtype, distill_weight: float = 0.0):
    """``step(tokens, mask, teacher) -> loss`` (device tensors; tokens
    and mask (Q, Q, T)), updating ``model`` in place."""
    from qrag_tpu_torch.models.cross_encoder import apply_gradients

    def step(tokens, mask, teacher):
        return apply_gradients(
            optimizer, listwise_loss(model, tokens, mask, teacher, dtype, distill_weight)
        )

    return step


def _groups(cfg: RerankEvalConfig, chunks: List[Chunk], train_idx: Sequence[int],
            rng: np.random.RandomState) -> Iterator[Tuple[List[str], List[int]]]:
    """Per step, (queries, chunk ids) of one group of Q chunks: a HARD
    group of one topic on even steps (in-batch negatives differ only by
    their rare tokens; topped up from the pool when the topic is
    short), a mixed group on odd ones."""
    ids = np.asarray(list(train_idx))
    by_topic: Dict[str, List[int]] = {}
    for i in train_idx:
        by_topic.setdefault(chunks[i].topic, []).append(i)
    topics = [t for t, members in by_topic.items() if len(members) >= 2]
    q_n = min(cfg.batch, len(ids))
    for it in range(cfg.steps):
        if topics and it % 2 == 0:
            topic = topics[rng.randint(len(topics))]
            pool = by_topic[topic]
            size = min(q_n, len(pool))
            picks = rng.choice(len(pool), size=size, replace=False)
            cis = [int(pool[p_]) for p_ in picks]
            if size < q_n:
                extra = [i for i in ids if i not in set(cis)]
                cis += [
                    int(x)
                    for x in rng.choice(extra, size=q_n - size, replace=False)
                ]
        else:
            picks = rng.choice(len(ids), size=q_n, replace=False)
            cis = [int(ids[p_]) for p_ in picks]
        yield [make_query(chunks[c], rng) for c in cis], cis


def pair_grid(qs: Sequence[str], docs: Sequence[str], max_len: int):
    """Tokens and masks (Q, M, T) of every (query_i, doc_j) pair."""
    from qrag_tpu_torch.models.cross_encoder import tokenize_pair

    toks = np.zeros((len(qs), len(docs), max_len), np.int32)
    masks = np.zeros((len(qs), len(docs), max_len), np.float32)
    for i, q in enumerate(qs):
        for j, d in enumerate(docs):
            toks[i, j], masks[i, j] = tokenize_pair(q, d, max_len)
    return toks, masks


def group_grids(cfg: RerankEvalConfig, chunks: List[Chunk], train_idx: Sequence[int],
                n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``pair_grid`` of each of the first ``n`` groups that
    ``train_cross_encoder`` draws (its generator, its order)."""
    groups = _groups(cfg, chunks, train_idx, np.random.RandomState(cfg.seed + 3))
    return [pair_grid(qs, [chunks[c].text for c in cis], cfg.max_len)
            for qs, cis in itertools.islice(groups, n)]


def _teacher(cfg: RerankEvalConfig, chunks: List[Chunk], init_dir: str, device):
    """``teacher(queries, chunk ids) -> (Q, Q)`` analytic fidelity over
    the warm-start bi-encoder's embeddings (the corpus embedded once)."""
    import torch

    from qrag_tpu_torch.models.bi_encoder import TrainedEmbedder
    from qrag_tpu_torch.ops.statevector import batched_fidelity

    t_emb = TrainedEmbedder(weights_dir=init_dir, device=device)
    all_doc_vecs = torch.from_numpy(
        np.asarray(t_emb([c.text for c in chunks]), np.float32)
    ).to(t_emb.device)

    def teacher(qs: List[str], cis: List[int]) -> "torch.Tensor":
        qv = torch.from_numpy(np.asarray(t_emb(qs), np.float32)).to(t_emb.device)
        dv = all_doc_vecs[torch.as_tensor(cis, device=t_emb.device)]
        return batched_fidelity(qv[:, None, :], dv[None, :, :], n_qubits=cfg.distill_qubits)

    return teacher


def train_cross_encoder(
    cfg: RerankEvalConfig,
    chunks: List[Chunk],
    train_idx: Sequence[int],
    hook=None,
    device=None,
):
    """In-batch listwise training on one device (activations bf16 on a
    CUDA device, f32 on the CPU).  ``hook(step, scorer)``
    fires every ``cfg.curve_every`` steps when given.  Returns
    ``(CrossEncoderScorer, loss trace)``, the trace ``(step, loss)``
    every 50 steps and at the last."""
    import torch

    from qrag_tpu_torch.device import resolve_device
    from qrag_tpu_torch.models import cross_encoder as ce
    from qrag_tpu_torch.models.weights import ordered_parameters

    device = resolve_device(device)
    dtype = ce.default_dtype(device)
    ce_cfg = _make_cfg(cfg)
    init_dir = resolve_init_from(cfg.init_from)
    if init_dir:
        params = warm_start_params(ce_cfg, init_dir)
    else:
        params = ce.init_params(ce_cfg, cfg.seed)
    model = ce.trainable(
        ce.load_module(ce.CrossEncoder(ce_cfg, pos_rows=params["pos_emb"].shape[0]), params),
        device,
    )
    optimizer = torch.optim.AdamW(
        ordered_parameters(model, ce_cfg), lr=cfg.lr, weight_decay=ce.ADAMW_DECAY
    )
    distill_w = float(cfg.distill_weight)
    teacher_fn = None
    if distill_w > 0.0:
        if not init_dir:
            raise ValueError(
                "distill_weight > 0 needs init_from (the teacher is "
                "fidelity over the warm-start bi-encoder's embeddings)"
            )
        teacher_fn = _teacher(cfg, chunks, init_dir, device)
    step = make_listwise_step(model, optimizer, dtype, distill_w)

    def scorer():
        return ce.CrossEncoderScorer(ce_cfg, params=ce.module_params(model), device=device)

    rng = np.random.RandomState(cfg.seed + 3)
    losses: List[Tuple[int, float]] = []
    for it, (qs, cis) in enumerate(_groups(cfg, chunks, train_idx, rng)):
        toks, masks = pair_grid(qs, [chunks[c].text for c in cis], cfg.max_len)
        tokens, mask = ce.device_batch(device, toks, masks)
        if teacher_fn is not None:
            teacher = teacher_fn(qs, cis)
        else:
            teacher = torch.zeros((len(cis), len(cis)), device=device)
        loss = step(tokens, mask, teacher)
        if it % 50 == 0 or it == cfg.steps - 1:
            losses.append((it, float(loss)))
        if hook is not None and cfg.curve_every and (it + 1) % cfg.curve_every == 0:
            hook(it + 1, scorer())
    return scorer(), losses


# ------------------------------------------------------------------ scoring


def _cosine_scorer(embedder, device):
    """The ClassicalReranker's cosine scoring (embed the query with the
    documents, cosine of each document to the query on ``device``)."""
    import torch

    from qrag_tpu_torch.ops.topk import cosine_scores

    def score(query: str, docs: List[str]) -> np.ndarray:
        embeds = torch.from_numpy(np.asarray(embedder([query] + list(docs)), np.float32))
        embeds = embeds.to(device)
        return cosine_scores(embeds[:1], embeds[1:])[0].cpu().numpy()

    return score


def _eval_cases(
    cfg: RerankEvalConfig,
    chunks: List[Chunk],
    hold_idx: Sequence[int],
    seed: int = 17,
) -> List[Tuple[str, List[int], int]]:
    """(query, candidate chunk ids, position of the true chunk)."""
    rng = np.random.RandomState(seed)
    all_ids = np.arange(len(chunks))
    by_topic: Dict[str, List[int]] = {}
    for i, c in enumerate(chunks):
        by_topic.setdefault(c.topic, []).append(i)
    cases = []
    for ci in hold_idx:
        for _ in range(cfg.queries_per_chunk):
            q = make_query(chunks[ci], rng)
            same = [j for j in by_topic[chunks[ci].topic] if j != ci]
            n_hard = min(len(same), (cfg.candidates - 1) // 2)
            hard = list(rng.choice(same, size=n_hard, replace=False))
            pool = [j for j in all_ids if j != ci and j not in set(hard)]
            rand = list(
                rng.choice(pool, size=cfg.candidates - 1 - n_hard, replace=False)
            )
            cand = [ci] + hard + rand
            order = rng.permutation(len(cand))
            cand = [cand[o] for o in order]
            cases.append((q, cand, cand.index(ci)))
    return cases


def eval_ranker(
    score_fn,
    chunks: List[Chunk],
    cases: List[Tuple[str, List[int], int]],
) -> Dict[str, float]:
    """top-1 / MRR / nDCG@10 of a (query, docs)->scores ranker over
    the candidate sets (single relevant doc per case)."""
    top1 = mrr = ndcg = 0.0
    for q, cand, true_pos in cases:
        scores = np.asarray(score_fn(q, [chunks[j].text for j in cand]))
        # descending scores; ties break to the earlier candidate
        order = np.argsort(-scores, kind="stable")
        rank = int(np.where(order == true_pos)[0][0]) + 1  # 1-based
        top1 += rank == 1
        mrr += 1.0 / rank
        ndcg += 1.0 / math.log2(rank + 1) if rank <= 10 else 0.0
    n = len(cases)
    return {
        "top1": round(top1 / n, 4),
        "mrr": round(mrr / n, 4),
        "ndcg@10": round(ndcg / n, 4),
    }


def run_eval(
    cfg: Optional[RerankEvalConfig] = None,
    weights_dir: Optional[str] = None,
    device=None,
) -> Dict[str, object]:
    from qrag_tpu_torch.device import resolve_device
    from qrag_tpu_torch.models.cross_encoder import CrossEncoderScorer
    from qrag_tpu_torch.pipeline.embeddings import HashEmbedder

    device = resolve_device(device)
    cfg = cfg or RerankEvalConfig()
    chunks = generate_corpus(
        cfg.n_episodes, cfg.chunks_per_episode, seed=cfg.seed
    )
    train_idx, hold_idx = split_by_episode(
        chunks, cfg.holdout_frac, seed=cfg.seed + 1
    )
    fit_idx = list(train_idx)
    if cfg.val_episode_frac > 0:
        # the fresh-seed validation corpus: episodes neither the
        # fine-tune nor the warm start's pretraining saw
        n_val_eps = max(1, int(round(cfg.val_episode_frac * cfg.n_episodes)))
        val_chunks = generate_corpus(
            n_val_eps, cfg.chunks_per_episode, seed=cfg.seed + 101
        )
        val_idx = list(range(len(val_chunks)))
    else:
        val_chunks = chunks
        val_idx = list(train_idx)[: len(hold_idx)]
    curve: List[Dict[str, object]] = []
    hook = None
    if cfg.curve_every:
        # fixed subsampled case sets so every curve point is comparable
        curve_val = _eval_cases(
            cfg, val_chunks, val_idx[: max(len(hold_idx), 1)], seed=29
        )[: cfg.curve_cases]
        curve_hold = _eval_cases(cfg, chunks, hold_idx)[: cfg.curve_cases]

        def hook(at_step, cur_scorer):
            curve.append(
                {
                    "step": at_step,
                    "val": eval_ranker(cur_scorer.score, val_chunks, curve_val),
                    "holdout": eval_ranker(cur_scorer.score, chunks, curve_hold),
                }
            )
            logger.info("curve @%d: %s", at_step, curve[-1])

    train_pool = chunks
    if cfg.extra_train_episodes > 0:
        # extra fine-tune episodes live outside the eval corpus
        extra_chunks = generate_corpus(
            cfg.extra_train_episodes, cfg.chunks_per_episode,
            seed=cfg.seed + 201,
        )
        train_pool = chunks + extra_chunks
        fit_idx = list(fit_idx) + list(range(len(chunks), len(train_pool)))
    t0 = time.time()
    scorer, losses = train_cross_encoder(cfg, train_pool, fit_idx, hook=hook, device=device)
    train_s = time.time() - t0
    cases = _eval_cases(cfg, chunks, hold_idx)

    picked = "fine-tuned"
    init_dir = resolve_init_from(cfg.init_from)
    warm = None
    if init_dir:
        # ship whichever of {step-0 warm start, fine-tuned} validates
        # better on the validation fold, so fine-tuning never ships
        # below the inherited bi-encoder quality
        warm = CrossEncoderScorer(
            _make_cfg(cfg), params=warm_start_params(_make_cfg(cfg), init_dir), device=device
        )
        val_cases = _eval_cases(
            cfg, val_chunks, val_idx[: max(len(hold_idx), 1)], seed=29
        )
        val_ft = eval_ranker(scorer.score, val_chunks, val_cases)
        val_w = eval_ranker(warm.score, val_chunks, val_cases)
        if val_w["ndcg@10"] > val_ft["ndcg@10"]:
            scorer, picked = warm, "warm-start (fine-tune regressed val)"

    out: Dict[str, object] = {
        "corpus_chunks": len(chunks),
        "held_out_chunks": len(hold_idx),
        "fit_chunks": len(fit_idx),
        "val_fold_chunks": len(val_idx) if cfg.val_episode_frac > 0 else 0,
        "val_protocol": (
            "fresh-corpus" if cfg.val_episode_frac > 0 else "train-slice (legacy)"
        ),
        "eval_cases": len(cases),
        "candidates_per_case": cfg.candidates,
        "steps": cfg.steps,
        "train_seconds": round(train_s, 1),
        "loss_trace": losses,
    }
    if cfg.distill_weight:
        out["distill_weight"] = cfg.distill_weight
    if curve:
        out["quality_curve"] = curve
    if cfg.init_from:
        out["warm_start"] = init_dir if init_dir else "MISSING (from scratch)"
    if init_dir:
        out["shipped_variant"] = picked
        out["val_finetuned"] = val_ft
        out["val_warmstart"] = val_w
    out["cross_encoder_trained"] = eval_ranker(scorer.score, chunks, cases)
    # the production fallback baseline: HashEmbedder(256) cosine
    out["cosine_hash"] = eval_ranker(
        _cosine_scorer(HashEmbedder(dim=256), device), chunks, cases
    )
    # untrained floor: a random-init cross-encoder (torch.Generator's
    # draw, so not the reference's number)
    untrained = CrossEncoderScorer(_make_cfg(cfg), seed=cfg.seed + 9, device=device)
    out["cross_encoder_untrained"] = eval_ranker(untrained.score, chunks, cases)
    if init_dir:
        from qrag_tpu_torch.models.bi_encoder import TrainedEmbedder

        # the strong cosine baseline: the trained bi-encoder's cosine
        bi = TrainedEmbedder(weights_dir=init_dir, device=device)
        out["cosine_trained_bi_encoder"] = eval_ranker(_cosine_scorer(bi, device), chunks, cases)
        # step-0 warm-start quality (the scorer of the ship rule)
        out["cross_encoder_warmstart_step0"] = eval_ranker(warm.score, chunks, cases)

    if weights_dir:
        scorer.save(weights_dir)
        out["weights_dir"] = weights_dir
    return out


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="train + rerank-quality eval (cross-encoder vs cosine)"
    )
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--episodes", type=int, default=48)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--weights-dir", default=None)
    p.add_argument(
        "--distill-weight", type=float, default=0.0,
        help="auxiliary fidelity-distillation MSE weight (0 = off)",
    )
    p.add_argument(
        "--curve-every", type=int, default=0,
        help="record val+holdout quality every N steps (0 = off)",
    )
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--val-episode-frac", type=float, default=0.25,
        help="fresh-seed validation corpus size as a fraction of "
        "n_episodes (the ship-rule fold; 0 = the legacy "
        "memorized-train-slice protocol)",
    )
    p.add_argument(
        "--extra-train-episodes", type=int, default=0,
        help="fresh-seed episodes appended to the fine-tune pool only "
        "(eval protocol unchanged)",
    )
    p.add_argument(
        "--init-from", default="artifacts/bi_encoder",
        help="bi-encoder artifact for the warm start ('' = from scratch)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = RerankEvalConfig(
        steps=args.steps,
        n_episodes=args.episodes,
        batch=args.batch,
        distill_weight=args.distill_weight,
        curve_every=args.curve_every,
        lr=args.lr,
        seed=args.seed,
        val_episode_frac=args.val_episode_frac,
        extra_train_episodes=args.extra_train_episodes,
        init_from=args.init_from or None,
    )
    print(json.dumps(run_eval(cfg, weights_dir=args.weights_dir, device=args.device), indent=2))


if __name__ == "__main__":
    main()
