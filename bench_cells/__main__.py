"""``python -m bench_cells CELL``: one run of a cell (see ``bench_cells``)."""

from __future__ import annotations

import argparse
import importlib
import sys

import torch

from bench_cells import CELLS, common


def _parse(argv):
    parser = argparse.ArgumentParser(prog="python -m bench_cells")
    parser.add_argument("cell", choices=sorted(CELLS))
    parser.add_argument("--seed", type=int, default=0, help="makes the rows and the queries")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu (the plain path, for tests)")
    parser.add_argument("--trace", action="store_true",
                        help="a traced run after the timed one (per-layer numbers)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_cells: no CUDA device; the cells measure the GPU (pass --device cpu "
              "for the plain path)", file=sys.stderr)
        return common.EXIT_NO_CUDA
    mod = importlib.import_module(CELLS[args.cell].module)
    result = mod.run(args.seed, device, traced=args.trace)
    return common.emit(result, mod.METRICS)


if __name__ == "__main__":
    sys.exit(main())
