"""Training of the cross-encoder on one device (PyTorch port of
``qrag_tpu.parallel.train``).

``make_trainer`` takes the place of the reference's
``make_sharded_trainer`` (DP x TP/EP over a mesh, parameters placed by
``partition_spec``, one jit of the whole step); the sharded counterpart
comes with the mesh (ROADMAP.md, Queue 1 item 8).  The optimizer is the
reference's ``optax.adamw(learning_rate)``: AdamW with optax's default
decay (``cross_encoder.ADAMW_DECAY``, 1e-4; torch's default is 1e-2) on
every parameter, biases, layer norms, embeddings and gates included, in
one parameter group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.models import cross_encoder as ce
from qrag_tpu_torch.models.weights import ordered_parameters


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
    steps: int = 20,
    batch: int = 32,
    seed: int = 0,
    device=None,
) -> float:
    """Short training run on one device; returns the final loss."""
    cfg = cfg or ce.CrossEncoderConfig(dim=64, n_heads=4, n_layers=2, max_len=128)
    _, _, step = make_trainer(cfg, device=device)
    rng = np.random.RandomState(seed)
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        loss = step(*synthetic_batch(rng, batch, cfg.max_len))
    return float(loss)
