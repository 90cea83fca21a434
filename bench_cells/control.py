"""``python -m bench_cells.control CELL [--seed S] [--device cuda|cpu]``:
the precision controls of a cell's answer check.

Each control puts an answer of a lower precision in the program's place,
at the cell's own sizes and inputs, and passes it through the cell's own
``check``, the one its ``correct`` comes from.  Cell A: ``bf16_reference``
(the oracle over bf16 rows and queries, its values too) and
``bf16_ranking_f32_values`` (the bf16 top-10, as the scan's candidates
without the certify tail, with its rows' f32 values: wrong only where a
row is).  Cell B: ``bf16_candidates`` (the bf16 top-100, not certified,
then the float64 fidelity: wrong only where a row is) and
``bf16_features`` (the f32 top-100, the fidelity of bf16 features).  It prints each control's readings beside the limits (``TIE_TOL``,
``VALUE_TOL``) and one JSON line, and exits 1 if a control passed the
check: a limit too loose to tell a lower precision from the program."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from bench_cells import common, search_exact, search_rerank

A, B = "search_exact_b1024_768d1m", "search_rerank_b1_1536d500k"


def _rounded(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, held in f32: the oracle over such rows and
    queries is the same products and sort over bf16 inputs."""
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def exact_controls(seed: int, device) -> dict:
    """Cell A's controls over the first ``CHECKED`` queries of each batch."""
    m = search_exact
    rows, queries = m.inputs(seed, device)
    f32, low = common.Oracle(rows, device), common.Oracle(_rounded(rows), device)
    answers = {"bf16_reference": [], "bf16_ranking_f32_values": []}
    for q in queries:
        q = q[: m.CHECKED]
        g_low = low.goodness(_rounded(q))
        idx = common.Oracle.order(g_low, m.K)
        g = f32.goodness(q)
        host = idx.cpu().numpy()
        answers["bf16_reference"].append((host, -g_low.gather(1, idx).cpu().numpy()))
        answers["bf16_ranking_f32_values"].append((host, -g.gather(1, idx).cpu().numpy()))
    del f32, low
    return {name: m.check(rows, queries, res, device) for name, res in answers.items()}


def rerank_controls(seed: int, device, chunk: int = 128) -> dict:
    """Cell B's controls over every timed request's query."""
    m = search_rerank
    rows, queries = m.inputs(seed, device)
    queries = queries[m.WARM_REQUESTS :]
    rows_low, queries_low = _rounded(rows), _rounded(queries)
    f32, low = common.Oracle(rows, device), common.Oracle(rows_low, device)
    feats, qfeats = m.features64(rows), m.features64(queries)
    feats_low, qfeats_low = m.features64(rows_low), m.features64(queries_low)
    replies = {"bf16_candidates": [], "bf16_features": []}
    for s in range(0, len(queries), chunk):
        for name, oracle, q, qf, df in (
                ("bf16_candidates", low, queries_low, qfeats, feats),
                ("bf16_features", f32, queries, qfeats_low, feats_low)):
            cand = oracle.order(oracle.goodness(q[s : s + chunk]), m.CANDIDATES).cpu().numpy()
            fid = m.fidelity64(qf[s : s + chunk], df[cand])
            sel = np.argsort(-fid, axis=1, kind="stable")[:, : m.K]
            top, top_fid = np.take_along_axis(cand, sel, 1), np.take_along_axis(fid, sel, 1)
            replies[name] += [list(zip(i.tolist(), f.tolist())) for i, f in zip(top, top_fid)]
    del f32, low
    return {name: m.check(rows, queries, r, device) for name, r in replies.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bench_cells.control")
    parser.add_argument("cell", choices=(A, B))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_cells.control: no CUDA device (pass --device cpu)", file=sys.stderr)
        return common.EXIT_NO_CUDA
    checks = (exact_controls if args.cell == A else rerank_controls)(args.seed, device)
    out = {"cell": args.cell, "seed": args.seed, "card": common.card(device)[1],
           "controls": {}}
    for name, c in checks.items():
        out["controls"][name] = {**c.readings(), "correct": not c.bad.any()}
        print(f"{args.cell} control {name}: correct = {not c.bad.any()} ({c.readings()})")
    print(json.dumps(out), flush=True)
    passed = [n for n, r in out["controls"].items() if r["correct"]]
    return common.EXIT_INCORRECT if passed else 0


if __name__ == "__main__":
    sys.exit(main())
