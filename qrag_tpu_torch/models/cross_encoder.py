"""The trained cross-encoder and its train step (PyTorch port of
``qrag_tpu.models.cross_encoder``).

A byte-level pre-LN transformer with a mixture-of-experts FFN scores
``[CLS] query [SEP] document [SEP]``.  Two heads:

* "cls": a linear readout of the CLS vector;
* "interaction": per-segment positions, attention restricted to the
  same segment's non-special keys plus a ``tanh(xgate)``-gated
  full-attention term in each layer, and a readout of
  ``interaction_temp * cosine(query pool, document pool)`` (pools
  through ``iproj``) plus the CLS logit.

The arithmetic follows the reference op for op: layer norm in f32 on
an f32 copy of the residual stream (population variance, eps 1e-5);
linear layers multiply in the activation dtype, add the f32 bias and
cast back; attention scores and their softmax are f32, cast to the
activation dtype before ``att @ v``; masking replaces a disallowed
score by -1e9 (a fully masked row averages every value uniformly, as
the reference's does); the MoE gates are an f32 softmax and every
expert computes every token; GELU is the tanh form.  Activations are
bf16 on a CUDA device and f32 on the CPU unless ``dtype`` says
otherwise; parameters stay f32.

Training follows the reference's ``bce_loss`` / ``make_train_step``:
the pointwise BCE in the reference's own formula, one backward, one
optimizer step.  The constructors make every parameter frozen (the scorer
runs in ``inference_mode``); ``trainable`` turns gradients on, and an
optimizer built over ``weights.ordered_parameters`` numbers its state
in the ``.npz`` order, which ``weights.adam_state_from_optax`` and
``models/checkpoint.py`` rely on.  ``remat=True`` recomputes each block
of the "cls" path in the backward pass (``torch.utils.checkpoint``, as
``jax.checkpoint`` does there); the interaction head, like the
reference's, never reads it.  ``partition_spec`` gives the sharding
rules that ``parallel/train.py`` places the parameters by.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.models.weights import params_from_npz, params_to_npz

# ---------------------------------------------------------------- tokenizer

PAD_ID = 256
CLS_ID = 257
SEP_ID = 258
VOCAB_SIZE = 259


def tokenize_pair(
    query: str, doc: str, max_len: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """``[CLS] query [SEP] doc [SEP]`` byte tokens + attention mask."""
    q = list(query.encode("utf-8"))
    d = list(doc.encode("utf-8"))
    budget = max_len - 3
    q = q[: budget // 2]
    d = d[: budget - len(q)]
    ids = [CLS_ID] + q + [SEP_ID] + d + [SEP_ID]
    ids = ids[:max_len]
    mask = [1] * len(ids)
    pad = max_len - len(ids)
    ids = ids + [PAD_ID] * pad
    mask = mask + [0] * pad
    return np.asarray(ids, np.int32), np.asarray(mask, np.float32)


def tokenize_batch(
    query: str, docs: Sequence[str], max_len: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    toks, masks = zip(*(tokenize_pair(query, d, max_len) for d in docs))
    return np.stack(toks), np.stack(masks)


# ------------------------------------------------------------------- config


@dataclass
class CrossEncoderConfig:
    vocab_size: int = VOCAB_SIZE
    max_len: int = 256
    dim: int = 256
    n_heads: int = 8
    n_layers: int = 4
    mlp_ratio: int = 4
    n_experts: int = 4  # MoE FFN experts; 0 = dense FFN
    head_type: str = "cls"  # "cls" | "interaction"
    interaction_temp: float = 20.0


# How far bf16 activations may move a sigmoid score from the same
# weights at f32 (shipped weights: at most 0.016 over 1,200 corpus
# pairs on the CPU; tests/test_torch_models.py holds it).
BF16_SCORE_ATOL = 0.03
# How far bf16 activations may move one in-batch listwise train step
# from the same step at f32 (the shipped recipe's geometry, warm-started
# from the shipped bi-encoder): the loss relative to the f32 loss, and
# the cosine between the two gradients over all parameters.  Readings on
# the CPU over two corpora x four groups of Q = 8
# (tests/test_torch_train.py::test_bf16_step_bounds): loss 0.0017-0.021,
# cosine 0.99758-0.99992; the bounds leave about twice the worst reading
# (loss 2.4x, cosine 2.1x its distance from 1).  chip_smoke.py holds
# the card to them.
BF16_STEP_LOSS_RTOL = 0.05
BF16_GRAD_COSINE_FLOOR = 0.995


def default_dtype(device: torch.device) -> torch.dtype:
    """The activation dtype: bf16 on a CUDA device, f32 elsewhere."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


# ------------------------------------------------------------------ modules


def _randn(gen: Optional[torch.Generator], *shape: int, scale: float = 1.0) -> nn.Parameter:
    if gen is None:
        return nn.Parameter(torch.zeros(shape), requires_grad=False)
    return nn.Parameter(torch.randn(shape, generator=gen) * scale, requires_grad=False)


def _const(value: float, *shape: int) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, float(value)), requires_grad=False)


class LayerNorm(nn.Module):
    """The reference's layer norm: population variance, eps 1e-5, on
    an f32 input (``F.layer_norm`` computes exactly that, in one
    kernel)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.g = _const(1.0, dim)
        self.b = _const(0.0, dim)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.g.shape, self.g, self.b, self.eps)


class Linear(nn.Module):
    """``x @ w`` in the activation dtype, ``+ b`` in f32, cast back."""

    def __init__(self, d_in: int, d_out: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.w = _randn(gen, d_in, d_out, scale=1.0 / math.sqrt(d_in))
        self.b = _const(0.0, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.matmul(x, self.w.to(x.dtype)).float() + self.b).to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention; ``allowed`` (bool, broadcast to
    (B, heads, Tq, Tk)) marks the keys each query may see."""

    def __init__(self, dim: int, n_heads: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, gen)
        self.out = Linear(dim, dim, gen)
        self.n_heads = n_heads

    def project(self, x: torch.Tensor):
        b, t, d = x.shape
        q, k, v = self.qkv(x).split(d, dim=-1)
        hd = d // self.n_heads
        return tuple(z.reshape(b, t, self.n_heads, hd).transpose(1, 2) for z in (q, k, v))

    def attend(self, q, k, v, allowed: torch.Tensor) -> torch.Tensor:
        b, h, t, hd = q.shape
        # bf16 x bf16 products are exact in f32: the scores are the
        # reference's f32 scores
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~allowed, -1e9)
        att = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, t, h * hd)
        return self.out(out)

    def forward(self, x: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        return self.attend(*self.project(x), allowed)


class MoEFFN(nn.Module):
    """Soft-routed MoE FFN, dense dispatch: every expert computes every
    token and the f32 router softmax mixes their outputs in f32."""

    def __init__(self, dim: int, hidden: int, n_experts: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.router = Linear(dim, n_experts, gen)
        self.w1 = _randn(gen, n_experts, dim, hidden, scale=1.0 / math.sqrt(dim))
        self.b1 = _const(0.0, n_experts, hidden)
        self.w2 = _randn(gen, n_experts, hidden, dim, scale=1.0 / math.sqrt(hidden))
        self.b2 = _const(0.0, n_experts, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gates = torch.softmax(self.router(x).float(), dim=-1)  # (b, t, E)
        h = torch.einsum("btd,edh->beth", x, self.w1.to(x.dtype)).float()
        h = F.gelu(h + self.b1[None, :, None, :], approximate="tanh")
        y = torch.einsum("beth,ehd->betd", h.to(x.dtype), self.w2.to(x.dtype)).float()
        y = y + self.b2[None, :, None, :]
        return torch.einsum("bte,betd->btd", gates, y).to(x.dtype)


class DenseFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.w1 = Linear(dim, hidden, gen)
        self.w2 = Linear(hidden, dim, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.w1(x).float(), approximate="tanh").to(x.dtype)
        return self.w2(h)


class Block(nn.Module):
    """Pre-LN transformer block (``ln1``, ``attn``, ``ln2``, ``moe`` or
    ``mlp``; the interaction head's layers add the ``xgate`` scalar)."""

    def __init__(self, cfg: CrossEncoderConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.dim)
        self.ln2 = LayerNorm(cfg.dim)
        self.attn = Attention(cfg.dim, cfg.n_heads, gen)
        hidden = cfg.dim * cfg.mlp_ratio
        if cfg.n_experts > 0:
            self.moe = MoEFFN(cfg.dim, hidden, cfg.n_experts, gen)
        else:
            self.mlp = DenseFFN(cfg.dim, hidden, gen)
        if cfg.head_type == "interaction":
            self.xgate = _const(0.0)  # closed at init

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.moe(x) if hasattr(self, "moe") else self.mlp(x)

    def forward(self, x: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        h = self.ln1(x.float()).to(x.dtype)
        x = x + self.attn(h, allowed)
        return x + self.ffn(self.ln2(x.float()).to(x.dtype))


class Tower(nn.Module):
    """Embeddings, blocks and the final layer norm, shared by the
    cross-encoder and the bi-encoder.  ``pos_rows`` is the row count of
    ``pos_emb`` (taken from the weights, which may hold fewer rows than
    ``max_len``)."""

    def __init__(self, cfg: CrossEncoderConfig, gen: Optional[torch.Generator] = None,
                 pos_rows: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = _randn(gen, cfg.vocab_size, cfg.dim, scale=0.02)
        self.pos_emb = _randn(gen, pos_rows or cfg.max_len, cfg.dim, scale=0.02)
        self.final_ln = LayerNorm(cfg.dim)
        self.layers = nn.ModuleList(Block(cfg, gen) for _ in range(cfg.n_layers))
        if cfg.head_type == "interaction":
            self.iproj = Linear(cfg.dim, cfg.dim, gen)

    def encode_plain(self, tokens: torch.Tensor, mask: torch.Tensor,
                     dtype: torch.dtype, remat: bool = False) -> torch.Tensor:
        """Absolute positions, key-masked blocks, final LN (f32);
        ``remat`` recomputes each block in the backward pass."""
        t = tokens.shape[1]
        if t > self.pos_emb.shape[0]:
            raise ValueError(
                f"{t} tokens exceed the {self.pos_emb.shape[0]} rows of pos_emb"
            )
        x = (self.tok_emb[tokens] + self.pos_emb[None, :t]).to(dtype)
        allowed = (mask > 0)[:, None, None, :]
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, allowed, use_reentrant=False)
            else:
                x = layer(x, allowed)
        return self.final_ln(x.float())


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _pool(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Masked mean over the token axis (f32)."""
    m = sel.float()[..., None]
    return (x * m).sum(1) / m.sum(1).clamp_min(1e-6)


class CrossEncoder(Tower):
    """Relevance logits (B,) of ``[CLS] q [SEP] d [SEP]`` token rows."""

    def __init__(self, cfg: CrossEncoderConfig, gen: Optional[torch.Generator] = None,
                 pos_rows: Optional[int] = None):
        super().__init__(cfg, gen, pos_rows)
        self.head = Linear(cfg.dim, 1, gen)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype = torch.float32, remat: bool = False) -> torch.Tensor:
        if self.cfg.head_type == "interaction":
            return self._interaction(tokens, mask, dtype)
        x = self.encode_plain(tokens, mask, dtype, remat)
        return x[:, 0, :] @ self.head.w[:, 0] + self.head.b[0]

    def _interaction(self, tokens, mask, dtype):
        t = tokens.shape[1]
        # segments: 0 = [CLS]+query, 1 = document, >= 2 = trailing
        seg = torch.cumsum((tokens == SEP_ID).to(torch.int32), dim=1)
        special = (tokens == CLS_ID) | (tokens == SEP_ID) | (tokens == PAD_ID)
        key_ok = (mask > 0) & ~special
        same = ((seg[:, :, None] == seg[:, None, :]) & key_ok[:, None, :])[:, None]
        full = key_ok[:, None, None, :]
        # per-segment positions: query bytes from 0 (CLS sits before 0),
        # document bytes from 0 just after the first SEP; clipped to the
        # rows the weights have
        first_sep = torch.argmax((tokens == SEP_ID).to(torch.int32), dim=1)
        pos = torch.arange(t, device=tokens.device)[None, :]
        pos_in = torch.where(seg == 0, pos - 1, pos - (first_sep + 1)[:, None])
        pos_in = pos_in.clamp(0, self.pos_emb.shape[0] - 1)
        x = (self.tok_emb[tokens] + self.pos_emb[pos_in]).to(dtype)
        for layer in self.layers:
            h = layer.ln1(x.float()).to(dtype)
            q, k, v = layer.attn.project(h)
            a_same = layer.attn.attend(q, k, v, same).float()
            a_full = layer.attn.attend(q, k, v, full).float()
            gate = torch.tanh(layer.xgate)
            x = x + (a_same + gate * (a_full - a_same)).to(dtype)
            x = x + layer.ffn(layer.ln2(x.float()).to(dtype))
        x = self.final_ln(x.float())
        logit = x[:, 0, :] @ self.head.w[:, 0] + self.head.b[0]
        key_q = (seg == 0) & key_ok
        key_d = (seg == 1) & key_ok
        pq = _unit(_pool(x, key_q) @ self.iproj.w + self.iproj.b)
        pd = _unit(_pool(x, key_d) @ self.iproj.w + self.iproj.b)
        return self.cfg.interaction_temp * (pq * pd).sum(-1) + logit


def load_module(module: nn.Module, params: Dict[str, np.ndarray]) -> nn.Module:
    """Copy {dotted name: array} into ``module`` (same names, same
    shapes; the module was built with the weights' ``pos_emb`` rows)."""
    module.load_state_dict(
        {name: torch.tensor(a, dtype=torch.float32) for name, a in params.items()},
        strict=True,
    )
    return module


def module_params(module: nn.Module) -> Dict[str, np.ndarray]:
    """{dotted name: f32 array} of a module's parameters, on the host."""
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def init_params(cfg: CrossEncoderConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters drawn from ``torch.Generator(seed)`` (the
    reference's scales; not jax.random's numbers)."""
    return module_params(CrossEncoder(cfg, torch.Generator().manual_seed(seed)))


def trainable(module: nn.Module, device) -> nn.Module:
    """``module`` on ``device`` with gradients on every parameter."""
    return module.to(device).requires_grad_(True)


def device_batch(device: torch.device, tokens: np.ndarray, *floats: np.ndarray):
    """Token ids (as int64) and f32 arrays on ``device``."""
    return (torch.from_numpy(tokens).to(device).long(),
            *(torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in floats))


# ----------------------------------------------------------------- sharding


def partition_spec(cfg: CrossEncoderConfig) -> Dict[str, Any]:
    """The reference's ``partition_spec`` tree: the parameter tree's
    keys, each leaf a tuple naming per axis the mesh axis it is split
    over (``"model"``) or None — the reference's ``PartitionSpec`` as a
    plain tuple (``P()`` is ``()``).  TP: attention qkv / out and the
    FFN hidden on "model"; EP: the experts' leading axis on "model".

    One placement differs from the reference's under the same spec.
    GSPMD splits the fused ``qkv.w`` (dim, 3·dim) into contiguous column
    blocks; ``parallel/train.shard_params`` splits q, k and v each by
    heads, so that a rank's block holds whole heads of all three and
    attention stays local to the rank.  The shard's shape is the same,
    (dim, 3·dim/mp); its columns are other ones."""
    layer_spec: Dict[str, Any] = {
        "ln1": {"g": (), "b": ()},
        "ln2": {"g": (), "b": ()},
        "attn": {
            "qkv": {"w": (None, "model"), "b": ("model",)},
            "out": {"w": ("model", None), "b": ()},
        },
    }
    if cfg.head_type == "interaction":
        layer_spec["xgate"] = ()
    if cfg.n_experts > 0:
        layer_spec["moe"] = {
            "router": {"w": (), "b": ()},
            "w1": ("model", None, None),
            "b1": ("model", None),
            "w2": ("model", None, None),
            "b2": ("model", None),
        }
    else:
        layer_spec["mlp"] = {
            "w1": {"w": (None, "model"), "b": ("model",)},
            "w2": {"w": ("model", None), "b": ()},
        }
    spec: Dict[str, Any] = {
        "tok_emb": (),
        "pos_emb": (),
        "final_ln": {"g": (), "b": ()},
        "head": {"w": (), "b": ()},
        "layers": [layer_spec] * cfg.n_layers,
    }
    if cfg.head_type == "interaction":
        spec["iproj"] = {"w": (), "b": ()}
    return spec


# ----------------------------------------------------------------- training


def bce_loss(model: CrossEncoder, tokens: torch.Tensor, mask: torch.Tensor,
             labels: torch.Tensor, dtype: torch.dtype, remat: bool = False) -> torch.Tensor:
    """Pointwise BCE on the logits, the reference's formula:
    ``mean(max(l, 0) - l*y + log1p(exp(-|l|)))``."""
    logits = model(tokens, mask, dtype, remat)
    return torch.mean(
        logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


# optax.adamw's default weight decay (torch.optim.AdamW's is 1e-2): the
# reference's trainer takes the default, rerank_eval passes it
ADAMW_DECAY = 1e-4


def bf16_step_deviation(build, loss_of) -> Tuple[float, float]:
    """``(|loss_bf16 - loss_f32| / |loss_f32|, gradient cosine)`` of one
    step from the same parameters and batch, bf16 activations against
    f32: ``build()`` gives a fresh trainable model, ``loss_of(model,
    dtype)`` its loss; the cosine is over all parameters at once."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build()
        loss = loss_of(model, dtype)
        loss.backward()
        out[dtype] = (float(loss.detach()),
                      torch.cat([p.grad.flatten() for p in model.parameters()]).double())
        del model, loss
    (l32, g32), (l16, g16) = out[torch.float32], out[torch.bfloat16]
    return abs(l16 - l32) / abs(l32), float(g32 @ g16 / (g32.norm() * g16.norm()))


def apply_gradients(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> torch.Tensor:
    """One optimizer step on ``loss``'s gradients; the loss, detached
    (still on the device: reading it waits for the step)."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_train_step(model: CrossEncoder, optimizer: torch.optim.Optimizer,
                    dtype: torch.dtype = torch.float32, remat: bool = False):
    """``train_step(tokens, mask, labels) -> loss``, which updates
    ``model`` in place through ``optimizer`` (the reference's
    ``make_train_step(cfg, optimizer)``: the module holds what its
    ``cfg`` and ``params`` held, the optimizer its ``opt_state``)."""

    def train_step(tokens, mask, labels):
        return apply_gradients(optimizer, bce_loss(model, tokens, mask, labels, dtype, remat))

    return train_step


# ------------------------------------------------------------------- scorer


def _geometry(cfg: CrossEncoderConfig) -> tuple:
    return (
        cfg.vocab_size, cfg.max_len, cfg.dim, cfg.n_heads, cfg.n_layers,
        cfg.mlp_ratio, cfg.n_experts, cfg.head_type,
    )


def _load_scorer_config(directory: str) -> Optional[CrossEncoderConfig]:
    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return CrossEncoderConfig(
        vocab_size=d.get("vocab_size", VOCAB_SIZE),
        max_len=d.get("max_len", 256),
        dim=d.get("dim", 256),
        n_heads=d.get("n_heads", 8),
        n_layers=d.get("n_layers", 4),
        mlp_ratio=d.get("mlp_ratio", 4),
        n_experts=d.get("n_experts", 4),
        head_type=d.get("head_type", "cls"),
        interaction_temp=d.get("interaction_temp", 20.0),
    )


class CrossEncoderScorer:
    """Inference wrapper of ClassicalReranker's "cross-encoder" method:
    tokenization + forward + sigmoid, with the reference's weight files.
    ``forward_calls`` counts the forwards run (one per ``score``)."""

    def __init__(
        self,
        cfg: Optional[CrossEncoderConfig] = None,
        params: Optional[Dict[str, np.ndarray]] = None,
        seed: int = 0,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.forward_calls = 0
        self._build(cfg or CrossEncoderConfig(), params, seed)

    def _build(self, cfg, params, seed=0) -> None:
        self.cfg = cfg
        if params is None:
            model = CrossEncoder(cfg, torch.Generator().manual_seed(seed))
        else:
            model = load_module(
                CrossEncoder(cfg, pos_rows=params["pos_emb"].shape[0]), params
            )
        self.model = model.to(self.device).eval()

    @classmethod
    def from_config(cls, classical_config, device=None,
                    dtype: Optional[torch.dtype] = None) -> "CrossEncoderScorer":
        """From a ClassicalConfig: the weights of
        ``<model_cache_dir>/<model_name>`` when present, whose
        config.json is authoritative for the geometry."""
        cache_dir = os.path.join(
            classical_config.model_cache_dir,
            classical_config.model_name.replace("/", "_"),
        )
        cfg = _load_scorer_config(cache_dir) or CrossEncoderConfig(
            max_len=min(classical_config.max_sequence_length, 512)
        )
        scorer = cls(cfg, device=device, dtype=dtype)
        if os.path.exists(os.path.join(cache_dir, "params.npz")):
            scorer.load(cache_dir)
        return scorer

    def logits(self, tokens: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """The model's f32 logits (B,) on the device."""
        with torch.inference_mode():
            out = self.model(
                torch.from_numpy(tokens).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device),
                self.dtype,
            )
        self.forward_calls += 1
        return out

    def score(self, query: str, docs: List[str]) -> np.ndarray:
        tokens, mask = tokenize_batch(query, docs, self.cfg.max_len)
        return torch.sigmoid(self.logits(tokens, mask)).cpu().numpy()

    # -- persistence: the JAX package's flat npz + config.json -----------

    @property
    def params(self) -> Dict[str, np.ndarray]:
        """{dotted name: f32 array} of the weights, on the host — the
        port's form of the reference's nested ``params`` tree
        (``weights.params_from_jax_tree`` maps that tree onto it)."""
        return module_params(self.model)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        params_to_npz(self.params, self.cfg, os.path.join(directory, "params.npz"))
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(asdict(self.cfg), f, indent=2)

    def load(self, directory: str) -> None:
        saved = _load_scorer_config(directory)
        cfg = saved if saved is not None and _geometry(saved) != _geometry(self.cfg) else self.cfg
        with np.load(os.path.join(directory, "params.npz")) as data:
            params = params_from_npz(data, cfg)
        self._build(cfg, params)

