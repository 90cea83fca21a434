"""``python -m bench_cells.spread RUNS.jsonl ...``: the spread of a
cell's runs against its bounds.

Reads the JSON lines that ``python -m bench_cells CELL`` printed last
(one a run, each run a fresh process), groups them by cell and seed, and
prints for each metric its runs, median and spread ((max - min) /
median) beside its bound in the cell's ``METRICS``, then one JSON line.  It exits 1 if a spread
exceeds half its bound: a bound must hold a run's noise twice over."""

from __future__ import annotations

import importlib
import json
import sys

import numpy as np

from bench_cells import CELLS


def spreads(results) -> dict:
    """{(cell, seed): {metric: {runs, median, min, max, spread, bound, ok}}}."""
    groups = {}
    for r in results:
        groups.setdefault((r["cell"], r["seed"]), []).append(r)
    out = {}
    for key, runs in groups.items():
        metrics = importlib.import_module(CELLS[key[0]].module).METRICS
        out[key] = {}
        for name, spec in metrics.items():
            v = np.array([r["metrics"][name]["value"] for r in runs], np.float64)
            med = float(np.median(v))
            spread = float((v.max() - v.min()) / med) if med else float(v.max() != v.min())
            out[key][name] = {"runs": v.tolist(), "median": med, "min": float(v.min()),
                              "max": float(v.max()), "spread": spread, "bound": spec.bound,
                              "ok": spread <= spec.bound / 2}
    return out


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    results = [json.loads(line) for p in paths for line in open(p) if line.strip()]
    table = spreads(results)
    for (cell, seed), metrics in table.items():
        for name, row in metrics.items():
            print(f"{cell} seed {seed} {name}: {len(row['runs'])} runs, median "
                  f"{row['median']:.6g}, min {row['min']:.6g}, max {row['max']:.6g}, spread "
                  f"{row['spread']:.4f} (bound {row['bound']:.4f}, ok {row['ok']})")
    print(json.dumps([{"cell": c, "seed": s, "metrics": m} for (c, s), m in table.items()]))
    return 0 if all(r["ok"] for m in table.values() for r in m.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
