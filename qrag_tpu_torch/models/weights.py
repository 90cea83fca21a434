"""The trained models' weights in the JAX package's flat ``.npz`` form.

The JAX package saves a model as ``p0 ... pN``: the leaves of
``jax.tree_util.tree_flatten`` over its parameter dict, which visits
dict keys in sorted order and lists in order.  For the shipped
cross-encoder (interaction head) that is ``final_ln{b,g}`` p0-1,
``head{b,w}`` p2-3, ``iproj{b,w}`` p4-5, then for each layer
``attn{out{b,w},qkv{b,w}}``, ``ln1``, ``ln2``,
``moe{b1,b2,router{b,w},w1,w2}``, ``xgate``, then ``pos_emb`` and
``tok_emb``.  The bi-encoder has no ``head``, ``iproj`` or ``xgate``,
and has ``proj`` before ``tok_emb``.

This module rebuilds that order from the configuration alone (no jax):
a leaf is named by its dotted path (``layers.0.attn.qkv.w``), which is
also its key in the port's ``nn.Module`` state dict.  An optimizer built
over ``ordered_parameters`` numbers its state in that order too, so the
Adam moments of optax (``mu``, ``nu``, ``count``, trees of the
parameters' shape) and of ``torch.optim`` (``exp_avg``, ``exp_avg_sq``,
``step``) map leaf for leaf (``adam_state_from_optax`` and its inverse).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch


def _tree(cfg) -> Dict[str, Any]:
    """The parameter tree's shape: nested dicts and lists, leaves None.
    ``cfg`` is a ``CrossEncoderConfig`` or a ``BiEncoderConfig`` (which
    has a ``tower``)."""
    bi = hasattr(cfg, "tower")
    t = cfg.tower if bi else cfg
    lin = {"w": None, "b": None}
    ln = {"g": None, "b": None}
    layer: Dict[str, Any] = {"ln1": ln, "ln2": ln, "attn": {"qkv": lin, "out": lin}}
    if t.head_type == "interaction":
        layer["xgate"] = None
    if t.n_experts > 0:
        layer["moe"] = {"router": lin, "w1": None, "b1": None, "w2": None, "b2": None}
    else:
        layer["mlp"] = {"w1": lin, "w2": lin}
    tree: Dict[str, Any] = {
        "tok_emb": None,
        "pos_emb": None,
        "final_ln": ln,
        "layers": [layer] * t.n_layers,
    }
    if t.head_type == "interaction":
        tree["iproj"] = lin
    if bi:
        tree["proj"] = lin  # towers pool, they do not classify: no "head"
    else:
        tree["head"] = lin
    return tree


def _leaves(tree: Any, prefix: str = "") -> Iterator[tuple]:
    """(dotted path, leaf) in ``tree_flatten`` order."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def param_paths(cfg) -> List[str]:
    """Dotted names of the parameters in the ``.npz`` order."""
    return [path for path, _ in _leaves(_tree(cfg))]


def params_from_npz(npz: Mapping[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """``p0 ... pN`` of a saved model as {dotted name: array}.  Shapes
    are the file's own (the shipped cross-encoder's ``pos_emb`` has
    fewer rows than its ``max_len``)."""
    paths = param_paths(cfg)
    missing = [f"p{i}" for i in range(len(paths)) if f"p{i}" not in npz]
    if missing:
        raise ValueError(
            f"weights hold {len(paths) - len(missing)} of the {len(paths)} "
            f"arrays this geometry needs (missing {missing[:3]})"
        )
    return {path: np.asarray(npz[f"p{i}"]) for i, path in enumerate(paths)}


def params_from_jax_tree(tree: Mapping[str, Any], cfg) -> Dict[str, np.ndarray]:
    """A JAX parameter dict (leaves as numpy arrays) as {dotted name:
    array}; its structure must be the one ``cfg`` gives."""
    flat = {path: np.asarray(leaf) for path, leaf in _leaves(tree)}
    if list(flat) != param_paths(cfg):
        raise ValueError("parameter tree does not match the configuration")
    return flat


def params_to_npz(params: Mapping[str, Any], cfg, path: str) -> None:
    """Write {dotted name: array} as the JAX package's ``p0 ... pN``."""
    np.savez(
        path,
        **{f"p{i}": np.asarray(params[name]) for i, name in enumerate(param_paths(cfg))},
    )


def ordered_parameters(module: torch.nn.Module, cfg) -> List[torch.nn.Parameter]:
    """The module's parameters in the ``.npz`` order: an optimizer built
    over them keys its state ``0 ... N`` as the file keys ``p0 ... pN``."""
    return [module.get_parameter(name) for name in param_paths(cfg)]


def _fill(tree: Any, leaves: Iterator) -> Any:
    """``tree``'s structure with its leaves taken from ``leaves`` in
    ``tree_flatten`` order."""
    if isinstance(tree, Mapping):
        return {key: _fill(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_fill(sub, leaves) for sub in tree]
    return next(leaves)


def adam_state(mu: List[Any], nu: List[Any], count: int) -> Dict[int, Dict[str, torch.Tensor]]:
    """The ``state`` of a ``torch.optim.Adam``/``AdamW`` state dict from
    first and second moments in ``param_paths`` order and the number of
    steps taken (optax's ``count``, after its increment)."""
    return {
        i: {"step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(np.asarray(m, np.float32)),
            "exp_avg_sq": torch.tensor(np.asarray(v, np.float32))}
        for i, (m, v) in enumerate(zip(mu, nu))
    }


def load_adam_state(optimizer: torch.optim.Optimizer, state: Dict[int, Dict[str, torch.Tensor]]) -> None:
    """Replace ``optimizer``'s per-parameter state (moved to each
    parameter's device by ``load_state_dict``)."""
    full = optimizer.state_dict()
    full["state"] = state
    optimizer.load_state_dict(full)


def adam_state_from_optax(mu_tree: Mapping[str, Any], nu_tree: Mapping[str, Any],
                          count: int, cfg) -> Dict[int, Dict[str, torch.Tensor]]:
    """optax's Adam state (``mu`` and ``nu`` as numpy trees of the
    parameters' structure, ``count``) as the ``state`` of a
    ``torch.optim`` Adam/AdamW over ``ordered_parameters(module, cfg)``;
    give it to ``load_adam_state``."""
    mu, nu = params_from_jax_tree(mu_tree, cfg), params_from_jax_tree(nu_tree, cfg)
    paths = param_paths(cfg)
    return adam_state([mu[p] for p in paths], [nu[p] for p in paths], count)


def adam_state_to_optax(state: Mapping[int, Mapping[str, torch.Tensor]], cfg) -> Tuple[Any, Any, int]:
    """The inverse of ``adam_state_from_optax``: ``(mu_tree, nu_tree,
    count)`` as numpy trees of the parameters' structure."""
    n = len(param_paths(cfg))
    if sorted(state) != list(range(n)):
        raise ValueError(f"optimizer state holds {len(state)} of the {n} parameters")
    mu = (state[i]["exp_avg"].detach().cpu().numpy() for i in range(n))
    nu = (state[i]["exp_avg_sq"].detach().cpu().numpy() for i in range(n))
    return _fill(_tree(cfg), mu), _fill(_tree(cfg), nu), int(state[0]["step"])
