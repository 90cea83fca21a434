"""Sequence-parallel cross-encoder forward (PyTorch port of
``qrag_tpu.models.sequence_parallel``).

The token axis of a batch splits over the mesh's "model" axis and the
batch over "data", one slot a rank:

  * embeddings, layer norms, FFN / MoE: pointwise over tokens — stay
    on the rank, no communication; ``pos_emb`` is read from row
    ``model index · T/S``;
  * attention: Q stays local to the rank's tokens; K, V and the key
    mask are gathered along the token axis over "model" (one gather of
    each a layer, ``collectives.gather_tokens``), so every rank attends
    over the whole sequence;
  * the CLS logit is read from the gathered final hidden states (CLS
    lives in model rank 0's block), and the data ranks' logits are
    gathered, so every rank returns all (B,) logits.

Activation memory for a length-T sequence drops from O(T) to O(T/S) on
each rank, plus the transient gathered K and V.  Like the reference, it
reads the CLS head with absolute positions and key masking whatever the
configuration's ``head_type``: for an "interaction" configuration it
computes the "cls" logit, not the interaction score (there is no
sequence-parallel interaction head in the reference).  The arithmetic is
the dense forward's (``cross_encoder.CrossEncoder``), op for op.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch
from torch import nn

from qrag_tpu_torch.models import cross_encoder as ce
from qrag_tpu_torch.parallel.collectives import all_gather_axis, axis_groups, gather_tokens
from qrag_tpu_torch.parallel.mesh import Mesh


def _module(params: Union[nn.Module, Dict[str, np.ndarray]], cfg: ce.CrossEncoderConfig,
            device: torch.device) -> nn.Module:
    if isinstance(params, nn.Module):
        return params.to(device)
    module = ce.CrossEncoder(cfg, pos_rows=params["pos_emb"].shape[0])
    return ce.load_module(module, params).to(device).eval()


def forward_sequence_parallel(
    params: Union[nn.Module, Dict[str, np.ndarray]],
    tokens,  # (B, T) ints; T divisible by the mesh's model size
    mask,  # (B, T)
    cfg: ce.CrossEncoderConfig,
    mesh: Mesh,
) -> torch.Tensor:
    """Relevance logits (B,) f32 on this rank's device, the token axis
    sharded over "model" and the batch over "data".  ``params`` is a
    ``CrossEncoder`` or its {dotted name: array}; ``tokens`` and
    ``mask`` are the whole batch (numpy or tensors), the same on every
    rank, each of which takes its block.  Every rank of the mesh's
    group calls it."""
    data, model = axis_groups(mesh)
    (i, j), = mesh.local_slots()
    device = mesh.device(i, j)
    tokens, mask = torch.as_tensor(np.asarray(tokens)), torch.as_tensor(np.asarray(mask))
    b, t = tokens.shape
    if t % model.size:
        raise ValueError(f"sequence length {t} does not split over the model axis ({model.size})")
    if b % data.size:
        raise ValueError(f"batch {b} does not split over the data axis ({data.size})")
    bl, tl = b // data.size, t // model.size
    net = _module(params, cfg, device)
    if t > net.pos_emb.shape[0]:
        raise ValueError(f"{t} tokens exceed the {net.pos_emb.shape[0]} rows of pos_emb")
    dtype = ce.default_dtype(device)
    rows, cols = slice(i * bl, (i + 1) * bl), slice(j * tl, (j + 1) * tl)
    toks = tokens[rows, cols].to(device).long()
    m = mask[rows, cols].to(device, torch.float32)
    x = (net.tok_emb[toks] + net.pos_emb[cols][None]).to(dtype)
    allowed = (gather_tokens(m, model, dim=1) > 0)[:, None, None, :]
    for layer in net.layers:
        h = layer.ln1(x.float()).to(dtype)
        q, k, v = layer.attn.project(h)  # (b, heads, tl, hd)
        k, v = gather_tokens(k, model, dim=2), gather_tokens(v, model, dim=2)
        x = x + layer.attn.attend(q, k, v, allowed)
        x = x + layer.ffn(layer.ln2(x.float()).to(dtype))
    cls = net.final_ln(gather_tokens(x, model, dim=1)[:, 0, :].float())
    logit = cls @ net.head.w[:, 0] + net.head.b[0]
    return all_gather_axis(logit, data, dim=0)


def score_long_documents(
    scorer_params: Union[nn.Module, Dict[str, np.ndarray]],
    cfg: ce.CrossEncoderConfig,
    mesh: Mesh,
    tokens,
    mask,
) -> torch.Tensor:
    """``forward_sequence_parallel`` for inference: no autograd graph,
    batch on "data" and tokens on "model"."""
    with torch.inference_mode():
        return forward_sequence_parallel(scorer_params, tokens, mask, cfg, mesh)
