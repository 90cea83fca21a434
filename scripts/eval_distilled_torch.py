"""Rerank-quality eval of a DISTILLED cross-encoder against the shipped
one, on the PyTorch/CUDA port (the counterpart of
``scripts/eval_distilled.py``): top-1 / MRR / nDCG@10 of each, and of
the trained bi-encoder's cosine, as one JSON object.

Uses the SAME protocol as ``qrag_tpu_torch.models.rerank_eval.run_eval``:
the full transcript corpus, episode-held-out eval cases with same-topic
hard distractors.

    python scripts/eval_distilled_torch.py --weights /tmp/distilled_student \
        [--device cuda|cpu] [--val]

(the device defaults to CUDA and raises without it; ``EVAL_OVERRIDES``
replaces fields of ``RerankEvalConfig``, e.g. to cut the corpus)
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qrag_tpu_torch.device import resolve_device  # noqa: E402
from qrag_tpu_torch.models.cross_encoder import CrossEncoderScorer  # noqa: E402
from qrag_tpu_torch.models.rerank_eval import (  # noqa: E402
    RerankEvalConfig,
    _cosine_scorer,
    _eval_cases,
    eval_ranker,
)
from qrag_tpu_torch.pipeline.corpus_gen import (  # noqa: E402
    generate_corpus,
    split_by_episode,
)

EVAL_OVERRIDES: dict = {}  # RerankEvalConfig fields (none: the protocol's)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True, help="distilled student dir")
    p.add_argument("--baseline", default="artifacts/cross_encoder")
    p.add_argument("--bi", default="artifacts/bi_encoder")
    p.add_argument(
        "--val", action="store_true",
        help="evaluate on the TRAIN-episode validation slice (fresh "
        "seed) instead of the held-out episodes — the slice SHIP "
        "decisions must use (no held-out peeking)",
    )
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = RerankEvalConfig(**EVAL_OVERRIDES)
    chunks = generate_corpus(
        cfg.n_episodes, cfg.chunks_per_episode, seed=cfg.seed
    )
    train_idx, hold_idx = split_by_episode(
        chunks, cfg.holdout_frac, seed=cfg.seed + 1
    )
    if args.val:
        cases = _eval_cases(chunks=chunks, cfg=cfg,
                            hold_idx=train_idx[: len(hold_idx)], seed=29)
    else:
        cases = _eval_cases(cfg, chunks, hold_idx)

    out = {"cases": len(cases), "device": str(device)}
    for name, d in (
        ("distilled_student", args.weights),
        ("shipped_cross_encoder", args.baseline),
    ):
        sc = CrossEncoderScorer(device=device)
        sc.load(d)
        out[name] = eval_ranker(sc.score, chunks, cases)
    try:
        from qrag_tpu_torch.models.bi_encoder import TrainedEmbedder

        bi = TrainedEmbedder(weights_dir=args.bi, device=device)
        out["cosine_trained_bi_encoder"] = eval_ranker(
            _cosine_scorer(bi, device), chunks, cases
        )
    except (OSError, ValueError) as e:  # the bi-encoder baseline is optional
        out["cosine_trained_bi_encoder"] = f"unavailable: {e}"
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
