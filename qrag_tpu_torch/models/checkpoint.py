"""Training-state checkpoint and resume (PyTorch port of
``qrag_tpu.models.checkpoint``).

A checkpoint directory holds the reference's JSON sidecar,
``config.json = {"step": N, "config": {...}}`` with every field of the
reference's ``CrossEncoderConfig`` (``dropout``, the activation dtype's
name and ``remat`` included), and the whole state in one
``state.npz``: the parameters as ``p0 ... pN`` in the npz order of
``models/weights.py``, then the Adam moments ``mu0 ... muN`` and
``nu0 ... nuN`` in the same order and the step ``count``.

The reference saves its state with orbax, whose files need jax (and
orbax) to read; the port imports neither, so it cannot read an orbax
state, and its own checkpoints are npz.  The parameters alone cross
between the packages through ``CrossEncoderScorer.save``'s
``params.npz``.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import Any, Dict, Tuple

import numpy as np
import torch

from qrag_tpu_torch.models.cross_encoder import CrossEncoderConfig, load_module, module_params
from qrag_tpu_torch.models.weights import adam_state, load_adam_state, param_paths

CONFIG_NAME = "config.json"
STATE_NAME = "state.npz"


def save_train_state(
    directory: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    step: int,
    cfg: CrossEncoderConfig,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
) -> None:
    """Write ``model``'s parameters, ``optimizer``'s Adam state (built
    over ``weights.ordered_parameters``) and ``step``."""
    os.makedirs(directory, exist_ok=True)
    config = {**asdict(cfg), "dropout": 0.0, "dtype": str(dtype).removeprefix("torch."),
              "remat": bool(remat)}
    with open(os.path.join(directory, CONFIG_NAME), "w") as f:
        json.dump({"step": int(step), "config": config}, f, indent=2)
    params = module_params(model)
    state = optimizer.state_dict()["state"]
    arrays: Dict[str, np.ndarray] = {}
    for i, name in enumerate(param_paths(cfg)):
        arrays[f"p{i}"] = params[name]
        # before the first step an optimizer holds no state: zero moments
        for key, src in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moment = state[i][src].detach().cpu().numpy() if i in state else 0 * params[name]
            arrays[f"{key}{i}"] = moment
    arrays["count"] = np.asarray(int(state[0]["step"]) if state else 0, np.int32)
    np.savez(os.path.join(directory, STATE_NAME), **arrays)


def load_train_state(
    directory: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
    cfg: CrossEncoderConfig,
) -> Tuple[int, Dict[str, Any]]:
    """Restore parameters and Adam state into ``model`` and
    ``optimizer`` in place; returns ``(step, config dict)``."""
    with open(os.path.join(directory, CONFIG_NAME)) as f:
        meta = json.load(f)
    paths = param_paths(cfg)
    with np.load(os.path.join(directory, STATE_NAME)) as data:
        load_module(model, {name: data[f"p{i}"] for i, name in enumerate(paths)})
        load_adam_state(optimizer, adam_state(
            [data[f"mu{i}"] for i in range(len(paths))],
            [data[f"nu{i}"] for i in range(len(paths))],
            int(data["count"]),
        ))
    return int(meta["step"]), meta["config"]
