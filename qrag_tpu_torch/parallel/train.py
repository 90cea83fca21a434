"""Training of the cross-encoder, on one device or sharded DP x TP/EP over
a mesh of processes (PyTorch port of ``qrag_tpu.parallel.train``).

``make_trainer`` trains on one device.  ``make_sharded_trainer`` is the
reference's: the batch splits over "data", and over "model" the
attention heads (qkv column-parallel, ``out`` row-parallel), the dense
FFN's hidden units (``w1`` by columns, ``w2`` by rows) or the experts
(their leading axis; the router and its softmax over all experts stay
replicated, each rank adds its experts' gated outputs).  Where the
reference's single jit lets XLA insert the collectives, here they are
Megatron's pair from ``collectives.py``: *f* before a column-parallel
layer (its backward sums the input's gradient over "model") and *g*
after a row-parallel one (its forward sums the partial outputs), plus
*f* on the router's gates, whose gradient each rank sees only for its
own experts.  After the backward every gradient is averaged over
"data" (one all-reduce of all of them), and the replicated parameters'
gradients over "model" too, which keeps their replicas bit-equal where
a kernel (the embedding gathers' backward) sums in a run-to-run order.
Each rank holds one slot of
the mesh; ``partition_spec`` says which parameters are split, and
``shard_params`` cuts them (q, k and v each by heads).

The optimizer is the reference's ``optax.adamw(learning_rate)``: AdamW
with optax's default decay (``cross_encoder.ADAMW_DECAY``, 1e-4;
torch's default is 1e-2) on every parameter, biases, layer norms,
embeddings and gates included, in one parameter group.  AdamW is
elementwise, so each rank steps its own shards.  On one process of one
slot the sharded step is ``make_trainer``'s, operation for operation.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qrag_tpu_torch.config import MeshConfig
from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.models import cross_encoder as ce
from qrag_tpu_torch.models.weights import adam_state, load_adam_state, ordered_parameters, param_paths
from qrag_tpu_torch.parallel.collectives import (
    Axis,
    all_gather_axis,
    all_reduce_axis,
    axis_groups,
    copy_to_model,
    reduce_from_model,
)
from qrag_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, make_mesh


def make_trainer(
    cfg: ce.CrossEncoderConfig,
    learning_rate: float = 3e-4,
    seed: int = 0,
    device=None,
    remat: bool = False,
):
    """Returns ``(model, optimizer, step_fn)``.

    ``step_fn(tokens, mask, labels)`` takes numpy arrays, moves them to
    the device, runs one BCE step and returns the loss (a device
    tensor).  Activations are bf16 on a CUDA device and f32 on the CPU;
    parameters and optimizer state are f32."""
    device = resolve_device(device)
    model = ce.trainable(ce.load_module(ce.CrossEncoder(cfg), ce.init_params(cfg, seed)), device)
    optimizer = torch.optim.AdamW(
        ordered_parameters(model, cfg), lr=learning_rate, weight_decay=ce.ADAMW_DECAY
    )
    train_step = ce.make_train_step(model, optimizer, ce.default_dtype(device), remat)

    def step_fn(tokens, mask, labels):
        return train_step(*ce.device_batch(device, tokens, mask, labels))

    return model, optimizer, step_fn


# ------------------------------------------------------------ placement


def _spec_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, tuple]]:
    """(dotted name, spec tuple) of a ``partition_spec`` tree."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _spec_leaves(sub, f"{prefix}{key}.")
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _spec_leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def param_specs(cfg: ce.CrossEncoderConfig) -> Dict[str, tuple]:
    """{dotted parameter name: its partition spec tuple}."""
    return dict(_spec_leaves(ce.partition_spec(cfg)))


def _by_heads(name: str) -> bool:
    return name.endswith("attn.qkv.w") or name.endswith("attn.qkv.b")


def _shard(name: str, a: np.ndarray, spec: tuple, mp: int, j: int) -> np.ndarray:
    """Block ``j`` of ``mp`` of ``a`` along its "model" axis (q, k and v
    each by heads for the fused qkv)."""
    if MODEL_AXIS not in spec:
        return a
    axis = spec.index(MODEL_AXIS)
    if a.shape[axis] % (3 * mp if _by_heads(name) else mp):
        raise ValueError(f"{name} {a.shape}: axis {axis} does not split {mp} ways")
    if _by_heads(name):
        return np.concatenate([np.split(p, mp, axis=axis)[j] for p in np.split(a, 3, axis=axis)],
                              axis=axis)
    return np.split(a, mp, axis=axis)[j]


def _unshard(name: str, blocks: List[np.ndarray], spec: tuple) -> np.ndarray:
    """The inverse of ``_shard`` over all ``mp`` blocks in model order."""
    if MODEL_AXIS not in spec:
        return blocks[0]
    axis = spec.index(MODEL_AXIS)
    if _by_heads(name):
        thirds = [np.split(b, 3, axis=axis) for b in blocks]
        return np.concatenate([t[n] for n in range(3) for t in thirds], axis=axis)
    return np.concatenate(blocks, axis=axis)


def _model_slot(mesh: Mesh) -> Tuple[int, int]:
    """(model size, this rank's model index) on a mesh of one slot a rank."""
    local = mesh.local_slots()
    if len(local) != 1:
        raise ValueError(f"the sharded trainer needs one slot a rank; this rank holds {local}")
    return mesh.shape[MODEL_AXIS], local[0][1]


def shard_params(params: Dict[str, np.ndarray], cfg: ce.CrossEncoderConfig,
                 mesh: Mesh) -> Dict[str, np.ndarray]:
    """This rank's block of every parameter ({dotted name: array}, the
    full tree) by ``partition_spec``."""
    mp, j = _model_slot(mesh)
    specs = param_specs(cfg)
    return {name: _shard(name, a, specs[name], mp, j) for name, a in params.items()}


# -------------------------------------------------- tensor-parallel modules


class _RowLinear(ce.Linear):
    """Row-parallel ``Linear``: this rank's rows of ``w``, the partial
    products summed over "model" (*g*) in f32, then the replicated bias."""

    def __init__(self, d_in: int, d_out: int, axis: Axis):
        super().__init__(d_in, d_out)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        part = torch.matmul(x, self.w.to(x.dtype)).float()
        return (reduce_from_model(part, self.axis) + self.b).to(x.dtype)


class _TPAttention(ce.Attention):
    """This rank's heads: qkv column-parallel (its heads' q, k and v
    columns) behind *f*, ``out`` row-parallel."""

    def __init__(self, dim: int, n_heads: int, axis: Axis):
        nn.Module.__init__(self)
        self.qkv = ce.Linear(dim, 3 * dim // axis.size)
        self.out = _RowLinear(dim // axis.size, dim, axis)
        self.n_heads = n_heads // axis.size
        self.axis = axis

    def project(self, x: torch.Tensor):
        b, t, _ = x.shape
        q, k, v = self.qkv(copy_to_model(x, self.axis)).chunk(3, dim=-1)
        hd = q.shape[-1] // self.n_heads
        return tuple(z.reshape(b, t, self.n_heads, hd).transpose(1, 2) for z in (q, k, v))


class _TPMoE(ce.MoEFFN):
    """This rank's experts; the router and its softmax over all experts
    replicated, the gates behind *f*, the gated sum behind *g*."""

    def __init__(self, dim: int, hidden: int, n_experts: int, axis: Axis):
        nn.Module.__init__(self)
        local = n_experts // axis.size
        self.router = ce.Linear(dim, n_experts)
        self.w1 = ce._randn(None, local, dim, hidden)
        self.b1 = ce._const(0.0, local, hidden)
        self.w2 = ce._randn(None, local, hidden, dim)
        self.b2 = ce._const(0.0, local, dim)
        self.first, self.local, self.axis = axis.index * local, local, axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gates = copy_to_model(torch.softmax(self.router(x).float(), dim=-1), self.axis)
        gates = gates[..., self.first : self.first + self.local]
        h = torch.einsum("btd,edh->beth", copy_to_model(x, self.axis), self.w1.to(x.dtype)).float()
        h = F.gelu(h + self.b1[None, :, None, :], approximate="tanh")
        y = torch.einsum("beth,ehd->betd", h.to(x.dtype), self.w2.to(x.dtype)).float()
        y = y + self.b2[None, :, None, :]
        return reduce_from_model(torch.einsum("bte,betd->btd", gates, y), self.axis).to(x.dtype)


class _TPDense(ce.DenseFFN):
    """``w1`` by columns behind *f*, ``w2`` row-parallel."""

    def __init__(self, dim: int, hidden: int, axis: Axis):
        nn.Module.__init__(self)
        self.w1 = ce.Linear(dim, hidden // axis.size)
        self.w2 = _RowLinear(hidden // axis.size, dim, axis)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.w1(copy_to_model(x, self.axis)).float(), approximate="tanh").to(x.dtype)
        return self.w2(h)


def sharded_module(cfg: ce.CrossEncoderConfig, model_axis: Axis,
                   pos_rows: Optional[int] = None) -> ce.CrossEncoder:
    """A ``CrossEncoder`` whose blocks hold this rank's shards (zeros;
    load them with ``load_module``), under the full model's names."""
    mp = model_axis.size
    hidden = cfg.dim * cfg.mlp_ratio
    if cfg.n_heads % mp or (cfg.n_experts % mp if cfg.n_experts else hidden % mp):
        raise ValueError(f"model axis {mp} does not split {cfg.n_heads} heads "
                         f"/ {cfg.n_experts} experts / {hidden} hidden units")
    model = ce.CrossEncoder(cfg, pos_rows=pos_rows)
    for layer in model.layers:
        layer.attn = _TPAttention(cfg.dim, cfg.n_heads, model_axis)
        if cfg.n_experts > 0:
            layer.moe = _TPMoE(cfg.dim, hidden, cfg.n_experts, model_axis)
        else:
            layer.mlp = _TPDense(cfg.dim, hidden, model_axis)
    return model


def make_sharded_trainer(
    cfg: ce.CrossEncoderConfig,
    mesh: Mesh,
    learning_rate: float = 3e-4,
    seed: int = 0,
    params: Optional[Dict[str, np.ndarray]] = None,
    remat: bool = False,
):
    """Returns ``(model, optimizer, step_fn)`` of this rank, DP x TP/EP
    over ``mesh`` (one slot a rank; every rank of the mesh's group
    calls it).  ``params`` ({dotted name: array}, the full tree; by
    default ``init_params(cfg, seed)``, the same on every rank) is
    sharded by ``shard_params``.  ``model.data_axis`` /
    ``model.model_axis`` are this rank's axes.

    ``step_fn(tokens, mask, labels)`` takes the FULL batch (numpy, the
    same on every rank), runs the BCE step on this rank's rows of it and
    returns the loss of the whole batch (the mean of the data ranks'
    losses), the same on every rank.  Activations are bf16 on a CUDA
    device and f32 on the CPU."""
    data_axis, model_axis = axis_groups(mesh)
    (i, j), = mesh.local_slots()
    device = mesh.device(i, j)
    full = params if params is not None else ce.init_params(cfg, seed)
    module = sharded_module(cfg, model_axis, full["pos_emb"].shape[0])
    model = ce.trainable(ce.load_module(module, shard_params(full, cfg, mesh)), device)
    model.data_axis, model.model_axis = data_axis, model_axis
    weights = ordered_parameters(model, cfg)
    optimizer = torch.optim.AdamW(weights, lr=learning_rate, weight_decay=ce.ADAMW_DECAY)
    dtype = ce.default_dtype(device)
    dp, mp = data_axis.size, model_axis.size
    specs = param_specs(cfg)
    replicated = [p for n, p in zip(param_paths(cfg), weights) if MODEL_AXIS not in specs[n]]

    def step_fn(tokens, mask, labels):
        if len(tokens) % dp:
            raise ValueError(f"a batch of {len(tokens)} does not split over data={dp}")
        rows = slice(data_axis.index * (len(tokens) // dp), (data_axis.index + 1) * (len(tokens) // dp))
        batch = ce.device_batch(device, tokens[rows], mask[rows], labels[rows])
        optimizer.zero_grad(set_to_none=True)
        loss = ce.bce_loss(model, *batch, dtype, remat)
        loss.backward()
        if mp > 1:
            # the model ranks' gradients of a replicated parameter are
            # equal but for the accumulation order of kernels that sum
            # in a run-to-run order (the embedding gathers'): their mean
            # keeps the replicas one
            _average(replicated, model_axis)
        if dp > 1:
            _average(weights, data_axis)
            loss = all_reduce_axis(loss.detach(), data_axis) / dp
        optimizer.step()
        return loss.detach()

    return model, optimizer, step_fn


def _average(params: List[torch.Tensor], axis: Axis) -> None:
    """Replace the gradients of ``params`` by their mean over ``axis``
    (one all-reduce of all of them)."""
    flat = all_reduce_axis(torch.cat([p.grad.flatten() for p in params]), axis) / axis.size
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def _gathered(model: nn.Module, cfg: ce.CrossEncoderConfig, local: Dict[str, torch.Tensor]):
    """{name: full array} from every model rank's ``local`` block."""
    specs = param_specs(cfg)
    axis = model.model_axis
    out = {}
    for name, t in local.items():
        spec = specs[name]
        if MODEL_AXIS not in spec:
            out[name] = t.detach().cpu().numpy()
            continue
        ax = spec.index(MODEL_AXIS)
        whole = all_gather_axis(t.detach().contiguous(), axis, ax).cpu().numpy()
        out[name] = _unshard(name, np.split(whole, axis.size, axis=ax), spec)
    return out


def gather_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       cfg: ce.CrossEncoderConfig):
    """The full parameters and Adam state of a sharded trainer, on every
    rank (each model rank passes its blocks; collective over "model"):
    ``(params, mu, nu, count)``, each a {dotted name: array}."""
    names = param_paths(cfg)
    params = _gathered(model, cfg, {n: model.get_parameter(n) for n in names})
    state = optimizer.state_dict()["state"]
    if not state:  # no step taken: zero moments, as ``save_train_state``
        zero = {n: 0 * a for n, a in params.items()}
        return params, zero, dict(zero), 0
    mu = _gathered(model, cfg, {n: state[k]["exp_avg"] for k, n in enumerate(names)})
    nu = _gathered(model, cfg, {n: state[k]["exp_avg_sq"] for k, n in enumerate(names)})
    return params, mu, nu, int(state[0]["step"])


def load_sharded_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       cfg: ce.CrossEncoderConfig, mesh: Mesh, params, mu, nu, count: int) -> None:
    """Put full parameters and Adam state ({dotted name: array}) into a
    sharded trainer, each rank its blocks."""
    ce.load_module(model, shard_params(params, cfg, mesh))
    names = param_paths(cfg)
    mu, nu = shard_params(mu, cfg, mesh), shard_params(nu, cfg, mesh)
    load_adam_state(optimizer, adam_state([mu[n] for n in names], [nu[n] for n in names], count))


# --------------------------------------------------------- synthetic data

_WORDS = [
    "podcast", "advert", "sponsor", "deal", "politics", "sport", "brand",
    "morgan", "episode", "interview", "discount", "news", "product",
    "climate", "music", "health", "money", "offer", "guest", "debate",
]


def synthetic_batch(
    rng: np.random.RandomState, batch: int, max_len: int = 128
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic relevance task: positive docs contain the query's
    words, negatives are disjoint word samples.  Labels 0/1."""
    toks, masks, labels = [], [], []
    for _ in range(batch):
        qw = list(rng.choice(_WORDS, size=3, replace=False))
        pos = rng.rand() < 0.5
        if pos:
            dw = qw + list(rng.choice(_WORDS, size=5))
            rng.shuffle(dw)
        else:
            rest = [w for w in _WORDS if w not in qw]
            dw = list(rng.choice(rest, size=8))
        t, m = ce.tokenize_pair(" ".join(qw), " ".join(dw), max_len)
        toks.append(t)
        masks.append(m)
        labels.append(1.0 if pos else 0.0)
    return (
        np.stack(toks),
        np.stack(masks),
        np.asarray(labels, np.float32),
    )


def train_demo(
    cfg: Optional[ce.CrossEncoderConfig] = None,
    mesh: Optional[Mesh] = None,
    steps: int = 20,
    batch: int = 32,
    seed: int = 0,
    device=None,
) -> float:
    """Short training run sharded over ``mesh`` (by default one slot on
    ``device``); returns the final loss, the same on every rank."""
    cfg = cfg or ce.CrossEncoderConfig(dim=64, n_heads=4, n_layers=2, max_len=128)
    mesh = mesh or make_mesh(MeshConfig(data_parallel=1, model_parallel=1), device=device)
    _, _, step = make_sharded_trainer(cfg, mesh)
    rng = np.random.RandomState(seed)
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        loss = step(*synthetic_batch(rng, batch, cfg.max_len))
    return float(loss)
