"""The trained bi-encoder and its contrastive train step (PyTorch port
of ``qrag_tpu.models.bi_encoder``).

The cross-encoder's tower (byte tokens, pre-LN blocks, MoE or dense
FFN) with masked mean pooling and a linear projection to ``out_dim``,
L2-normalized.  `TrainedEmbedder` adapts trained weights to the
pipeline's embedder interface (texts -> (N, dim) f32), so the engine,
the ingestion tools and the MCP server embed with learned vectors
(``embedding.provider="trained"``).  Training follows the reference's
``info_nce_loss`` / ``make_train_step``: symmetric in-batch InfoNCE over
``temperature * q @ d.T`` (log-softmax over both axes, the mean of the
diagonal), one backward, one optimizer step; ``remat=True`` recomputes
each block in the backward pass, as ``jax.checkpoint`` does in
``encode``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.models.cross_encoder import (
    PAD_ID,
    CrossEncoderConfig,
    Linear,
    Tower,
    _pool,
    _unit,
    apply_gradients,
    default_dtype,
    load_module,
    module_params,
)
from qrag_tpu_torch.models.cross_encoder import partition_spec as _tower_partition_spec
from qrag_tpu_torch.models.weights import params_from_npz, params_to_npz


# The least cosine between a bf16-activation embedding and its f32 twin
# from the same weights (shipped weights: 0.99986 at the least over 642
# texts on the CPU; tests/test_torch_models.py holds it).
BF16_COSINE_FLOOR = 0.999
# How far bf16 activations may move one InfoNCE train step from the
# same step at f32 (the shipped recipe's geometry): the loss relative to
# the f32 loss, and the cosine between the two gradients over all
# parameters.  Readings on the CPU over three inits x two batches of 32
# (tests/test_torch_train.py::test_bf16_step_bounds): loss
# 1.8e-5-0.0012, cosine at least 0.99995; the bounds leave twice the
# worst reading.  chip_smoke.py holds the card to them.
BF16_STEP_LOSS_RTOL = 0.0025
BF16_GRAD_COSINE_FLOOR = 0.9999


@dataclass
class BiEncoderConfig:
    tower: CrossEncoderConfig = field(
        default_factory=lambda: CrossEncoderConfig(max_len=128)
    )
    out_dim: int = 256
    temperature: float = 20.0  # the training loss's logit scale


def partition_spec(cfg: BiEncoderConfig) -> Dict[str, Any]:
    """The reference's tree (``cross_encoder.partition_spec`` of the
    tower, without ``head``, with a replicated ``proj``)."""
    spec = _tower_partition_spec(cfg.tower)
    del spec["head"]
    spec["proj"] = {"w": (), "b": ()}
    return spec


def tokenize_texts(
    texts: Sequence[str], max_len: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Byte tokens + mask for single texts (no CLS/SEP framing)."""
    toks = np.full((len(texts), max_len), PAD_ID, np.int32)
    mask = np.zeros((len(texts), max_len), np.float32)
    for i, t in enumerate(texts):
        ids = np.frombuffer(t.encode("utf-8")[:max_len], np.uint8)
        toks[i, : ids.size] = ids
        mask[i, : ids.size] = 1.0
    return toks, mask


class BiEncoder(Tower):
    """Unit-norm embeddings (B, out_dim) of byte-token rows."""

    def __init__(self, cfg: BiEncoderConfig, gen: Optional[torch.Generator] = None,
                 pos_rows: Optional[int] = None):
        super().__init__(cfg.tower, gen, pos_rows)
        self.proj = Linear(cfg.tower.dim, cfg.out_dim, gen)
        self.temperature = cfg.temperature

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype = torch.float32, remat: bool = False) -> torch.Tensor:
        x = self.encode_plain(tokens, mask, dtype, remat)
        return _unit(_pool(x, mask > 0) @ self.proj.w + self.proj.b)


def init_params(cfg: BiEncoderConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters drawn from ``torch.Generator(seed)`` (the
    reference's scales; not jax.random's numbers)."""
    return module_params(BiEncoder(cfg, torch.Generator().manual_seed(seed)))


def info_nce_loss(model: BiEncoder, q_tokens, q_mask, d_tokens, d_mask,
                  dtype: torch.dtype, remat: bool = False) -> torch.Tensor:
    """In-batch negatives, symmetric: row i's positive is column i."""
    q = model(q_tokens, q_mask, dtype, remat)
    d = model(d_tokens, d_mask, dtype, remat)
    logits = model.temperature * (q @ d.T)
    ce_qd = -torch.log_softmax(logits, dim=1).diagonal().mean()
    ce_dq = -torch.log_softmax(logits, dim=0).diagonal().mean()
    return 0.5 * (ce_qd + ce_dq)


def make_train_step(model: BiEncoder, optimizer: torch.optim.Optimizer,
                    dtype: torch.dtype = torch.float32, remat: bool = False):
    """``train_step(q_tokens, q_mask, d_tokens, d_mask) -> loss``,
    updating ``model`` in place (the reference's ``make_train_step``)."""

    def train_step(q_tokens, q_mask, d_tokens, d_mask):
        loss = info_nce_loss(model, q_tokens, q_mask, d_tokens, d_mask, dtype, remat)
        return apply_gradients(optimizer, loss)

    return train_step


def synthetic_pairs(
    rng: np.random.RandomState, batch: int, max_len: int = 128
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(query, positive doc) pairs from the shared synthetic task."""
    from qrag_tpu_torch.parallel.train import _WORDS

    qs, ds = [], []
    for _ in range(batch):
        qw = list(rng.choice(_WORDS, size=3, replace=False))
        dw = qw + list(rng.choice(_WORDS, size=5))
        rng.shuffle(dw)
        qs.append(" ".join(qw))
        ds.append(" ".join(dw))
    qt, qm = tokenize_texts(qs, max_len)
    dt, dm = tokenize_texts(ds, max_len)
    return qt, qm, dt, dm


class TrainedEmbedder:
    """Pipeline embedder backed by trained bi-encoder weights.  A
    weights directory's config.json is authoritative for the geometry."""

    def __init__(
        self,
        cfg: Optional[BiEncoderConfig] = None,
        params: Optional[Dict[str, np.ndarray]] = None,
        weights_dir: Optional[str] = None,
        seed: int = 0,
        batch_size: int = 64,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        if weights_dir:
            cfg = _load_config(weights_dir) or cfg
        self.cfg = cfg or BiEncoderConfig()
        self.dim = self.cfg.out_dim
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        if weights_dir:
            with np.load(os.path.join(weights_dir, "bi_encoder.npz")) as data:
                params = params_from_npz(data, self.cfg)
        if params is None:
            model = BiEncoder(self.cfg, torch.Generator().manual_seed(seed))
        else:
            model = load_module(
                BiEncoder(self.cfg, pos_rows=params["pos_emb"].shape[0]), params
            )
        self.model: nn.Module = model.to(self.device).eval()

    def encode(self, tokens: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(
                torch.from_numpy(tokens).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device),
                self.dtype,
            )

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out = []
        for i in range(0, len(texts), self.batch_size):
            toks, mask = tokenize_texts(texts[i : i + self.batch_size], self.cfg.tower.max_len)
            mask[:, 0] = 1.0  # an empty string pools its first (PAD) token
            out.append(self.encode(toks, mask).float().cpu().numpy())
        return np.concatenate(out, axis=0)

    def params(self) -> Dict[str, np.ndarray]:
        return module_params(self.model)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        params_to_npz(self.params(), self.cfg, os.path.join(directory, "bi_encoder.npz"))
        t = self.cfg.tower
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(
                {
                    "tower": {
                        "vocab_size": t.vocab_size,
                        "max_len": t.max_len,
                        "dim": t.dim,
                        "n_heads": t.n_heads,
                        "n_layers": t.n_layers,
                        "mlp_ratio": t.mlp_ratio,
                        "n_experts": t.n_experts,
                    },
                    "out_dim": self.cfg.out_dim,
                    "temperature": self.cfg.temperature,
                },
                f,
                indent=2,
            )


def _load_config(directory: str) -> Optional[BiEncoderConfig]:
    """A saved config.json, or None."""
    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    t = d.get("tower", {})
    return BiEncoderConfig(
        tower=CrossEncoderConfig(
            vocab_size=t.get("vocab_size", 259),
            max_len=t.get("max_len", 128),
            dim=t.get("dim", 256),
            n_heads=t.get("n_heads", 8),
            n_layers=t.get("n_layers", 4),
            mlp_ratio=t.get("mlp_ratio", 4),
            n_experts=t.get("n_experts", 4),
        ),
        out_dim=d.get("out_dim", 256),
        temperature=d.get("temperature", 20.0),
    )
