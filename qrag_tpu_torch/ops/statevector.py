"""Analytic quantum-fidelity scores (PyTorch port of the all-real
product-form paths of ``qrag_tpu.ops.statevector``).

The reference encoding circuit (ry(v_i pi), rz(v_i pi / 2) per qubit,
then a CX ladder) is shared by query and document, so the ladder
cancels inside <psi_q|psi_d> and the fidelity factors per qubit:

    |c_k|^2 = A^2 + B^2 + 2AB cos(dphi),
    A = cos(tq/2)cos(td/2), B = sin(tq/2)sin(td/2), dphi = phi_q - phi_d

O(n_qubits) real arithmetic per pair.  The complex statevector,
amplitude and swap-test paths are not ported yet (ROADMAP.md, Queue 1
slice 7).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalize; zero vectors pass through unchanged."""
    norm = torch.linalg.norm(v, dim=dim, keepdim=True)
    return torch.where(norm > 0, v / torch.where(norm > 0, norm, 1.0), v)


def _per_qubit_product(qa: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    half_tq = qa * (math.pi / 2)
    half_td = da * (math.pi / 2)
    dphi = (qa - da) * (math.pi / 2)
    a = torch.cos(half_tq) * torch.cos(half_td)
    b = torch.sin(half_tq) * torch.sin(half_td)
    return torch.prod(a * a + b * b + 2.0 * a * b * torch.cos(dphi), dim=-1)


def fidelity_analytic(
    query_vec: torch.Tensor, doc_vecs: torch.Tensor, n_qubits: int
) -> torch.Tensor:
    """Exact fidelity of (m,) query x (N, m) docs -> (N,) via the
    product form (zero angles pad un-rotated qubits exactly)."""
    q = _normalize(query_vec.to(torch.float32))
    d = _normalize(doc_vecs.to(torch.float32))
    kq = min(q.shape[-1], n_qubits)
    kd = min(d.shape[-1], n_qubits)
    k = max(kq, kd)
    qa = F.pad(q[..., :kq], (0, k - kq))
    da = F.pad(d[..., :kd], (0, k - kd))
    return _per_qubit_product(qa, da)


def rotation_features(
    vectors: torch.Tensor, n_qubits: int, sqnorms: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The first ``n_qubits`` components of each L2-NORMALIZED vector —
    all the analytic fidelity reads (zero-padded past the width)."""
    vectors = vectors.to(torch.float32)
    if sqnorms is None:
        sqnorms = torch.sum(vectors * vectors, dim=-1)
    inv = torch.where(
        sqnorms > 0, torch.rsqrt(torch.clamp_min(sqnorms, 1e-30)), 1.0
    )
    k = min(vectors.shape[-1], n_qubits)
    feats = vectors[..., :k] * inv[..., None]
    return F.pad(feats, (0, n_qubits - k))


def fidelity_from_features(
    q_feat: torch.Tensor,  # (..., n_qubits)
    d_feats: torch.Tensor,  # (..., C, n_qubits)
) -> torch.Tensor:
    """Analytic fidelity from ``rotation_features`` -> (..., C)."""
    return _per_qubit_product(q_feat[..., None, :], d_feats)
