"""What both cells share: the seeded inputs, the f32 oracle and its
tie-aware comparison, percentiles, and the printed result.

The oracle is the benchmark's own: ``torch.matmul`` in IEEE f32 (TF32
off) over the rows the benchmark generated, then a full stable sort,
lower index first on ties.  It calls nothing of ``qrag_tpu_torch``, so
it is independent of the scan kernel and of the certify tail."""

from __future__ import annotations

import contextlib
import json
import sys
from typing import NamedTuple

import numpy as np
import torch

import bench_torch as bt

EXIT_INCORRECT = 1  # an answer differed from the reference, or a request failed
EXIT_NO_CUDA = 2  # no card and no --device cpu: the benchmark never runs unasked
# The answer limits.  On an H100 the sound runs read at most 7.2e-7 (A's
# values), 4.9e-7 (B's fidelities) and 1.7e-7 (B's largest tie gap); the
# bf16 controls (control.py) read 1.2e-4 to 3.5e-3 and fail on 473 to
# 3,072 of the checked answers (PERF.md §2): each limit sits about ten
# times from the readings on either side.
TIE_TOL = 1e-5  # scores this close are a tie: their order may differ
VALUE_TOL = 1e-5  # returned values against the reference's


class Metric(NamedTuple):
    unit: str
    better: str  # "higher" or "lower"
    bound: float  # the worsening (a fraction of the median) a change may cost


def query_seed(seed: int) -> int:
    """The queries' generator seed, derived from ``seed``: a stream apart
    from the rows' (32 bits, all a CPU generator keeps)."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])


def seeded_rows(n: int, d: int, seed: int, device) -> np.ndarray:
    """(n, d) host f32 unit rows, made on ``device`` from ``seed``."""
    return bt.unit_rows(n, d, seed, torch.float32, device).cpu().numpy()


def card(device: torch.device) -> tuple:
    """(the device's name, nvidia-smi's "name, power limit")."""
    if device.type != "cuda":
        return "cpu", "cpu"
    return torch.cuda.get_device_name(device), bt._card(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def ieee_f32():
    """f32 products in IEEE f32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


class Oracle:
    """The f32 reference over a corpus held on the device."""

    def __init__(self, rows: np.ndarray, device: torch.device):
        self.rows = torch.from_numpy(rows).to(device)
        self.sq = torch.sum(self.rows * self.rows, dim=1)

    def goodness(self, q: np.ndarray) -> torch.Tensor:
        """(B, N) f32 L2 goodness 2 q.x - |q|^2 - |x|^2 (nearer is larger)."""
        qt = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(self.rows.device)
        with ieee_f32():
            dots = qt @ self.rows.T
        return 2.0 * dots - torch.sum(qt * qt, dim=1, keepdim=True) - self.sq[None, :]

    @staticmethod
    def order(g: torch.Tensor, k: int) -> torch.Tensor:
        """The first ``k`` of a full stable sort: lower index first on ties."""
        return torch.sort(g, dim=1, descending=True, stable=True).indices[:, :k]


class Check(NamedTuple):
    bad: np.ndarray  # (B,) bool: the row's answer differs from the reference
    index_bad: np.ndarray  # (B,) bool: another index where the scores differ by > TIE_TOL
    value_bad: np.ndarray  # (B,) bool: a value off by > VALUE_TOL
    reorders: int  # positions where a tie within TIE_TOL was ordered otherwise
    max_index_gap: float  # the largest reference-score gap at a position of another index
    max_value_err: float

    def readings(self) -> dict:
        """What the check read, each beside the limit it was held to."""
        return {"checked": int(self.bad.size), "wrong": int(self.bad.sum()),
                "wrong_by_index": int(self.index_bad.sum()),
                "wrong_by_value": int(self.value_bad.sum()), "tie_reorders": self.reorders,
                "max_index_gap": self.max_index_gap, "tie_tol": TIE_TOL,
                "max_value_err": self.max_value_err, "value_tol": VALUE_TOL}


def compare(got: np.ndarray, want: np.ndarray, got_ref: np.ndarray, want_ref: np.ndarray,
            got_vals: np.ndarray, want_vals: np.ndarray) -> Check:
    """(B, k) returned indices against the reference's.  A position may
    hold another index only where the two rows' reference scores there
    (``got_ref``, ``want_ref``) lie within ``TIE_TOL``; every returned
    value lies within ``VALUE_TOL`` of the reference's at its position;
    a padded (-1) index is wrong."""
    diff = got != want
    gap = np.abs(got_ref.astype(np.float64) - want_ref)
    tie = gap <= TIE_TOL
    err = np.abs(got_vals.astype(np.float64) - want_vals)
    index_bad = (got < 0).any(axis=1) | (diff & ~tie).any(axis=1)
    value_bad = ~(err <= VALUE_TOL).all(axis=1)
    return Check(index_bad | value_bad, index_bad, value_bad, int((diff & tie).sum()),
                 float(gap[diff].max()) if diff.any() else 0.0,
                 float(err.max()) if err.size else 0.0)


def merge(checks) -> Check:
    """One check of the rows of ``checks``, in order."""
    return Check(*(np.concatenate([getattr(c, f) for c in checks])
                   for f in ("bad", "index_bad", "value_bad")),
                 sum(c.reorders for c in checks), max(c.max_index_gap for c in checks),
                 max(c.max_value_err for c in checks))


def percentiles(ms, *ps) -> list:
    return [float(np.percentile(np.asarray(ms, np.float64), p)) for p in ps]


def emit(result: dict, metrics: dict) -> int:
    """Prints every metric by name with its unit and bound, then the
    result as one JSON line; returns the exit code."""
    print(f"cell {result['cell']} (configuration {result['configuration']}, seed "
          f"{result['seed']}) on {result['card']}")
    for name, spec in metrics.items():
        print(f"  {name} = {result['metrics'][name]['value']:.6g} {spec.unit} "
              f"({spec.better} is better; bound {spec.bound:.0%} of the median)")
    for name, value in result["counts"].items():
        print(f"  {name} = {value}")
    print(f"  correct = {result['correct']} ({result['check']})")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else EXIT_INCORRECT


def metric_values(values: dict, metrics: dict) -> dict:
    return {name: {"value": values[name], "unit": spec.unit, "better": spec.better,
                   "bound": spec.bound} for name, spec in metrics.items()}
