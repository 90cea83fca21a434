"""Batched quantum statevector ops (PyTorch port of
``qrag_tpu.ops.statevector``).

The reference encoding circuit, per vector v (normalized):
ry(v_i pi) and rz(v_i pi / 2) on qubit i for the first min(len(v), n)
components, then the CX ladder cx(i, i+1); the score is
|<psi_q|psi_d>|^2.  Conventions are Qiskit's: little-endian (statevector
index bit k == qubit k), RY(t) = [[cos t/2, -sin t/2], [sin t/2,
cos t/2]], RZ(t) = diag(e^{-it/2}, e^{it/2}), initial state |0...0>.

Two evaluation paths, both exact:

* the full statevector (``encode_statevector`` + ``fidelity_statevector``)
  builds the 2^n ``torch.complex64`` amplitudes by contracting the
  per-qubit states and applying the CX ladder: O(2^n) per vector, the
  general circuit semantics and the in-repo oracle of the analytic path;
* the analytic product form (``fidelity_analytic``): the ladder is
  shared by query and document, so it cancels inside the overlap and
  the fidelity factors per qubit,

    |c_k|^2 = A^2 + B^2 + 2AB cos(dphi),
    A = cos(tq/2)cos(td/2), B = sin(tq/2)sin(td/2), dphi = phi_q - phi_d

  O(n_qubits) real arithmetic per pair.

The amplitude encoding (the vector IS the statevector) and the swap
test it reads out are here too.  Every function broadcasts over leading
dimensions: an (m,) query against (N, m) documents gives (N,) scores,
(P, m) against (P, m) one score per pair.
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


def encode_product_amplitudes(vectors: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """(..., m) real vectors -> (..., n, 2) complex64 per-qubit states of
    the pre-entanglement product state: qubit i after
    ``rz(v_i pi/2) ry(v_i pi) |0>`` is [cos(v_i pi/2) e^{-i v_i pi/4},
    sin(v_i pi/2) e^{+i v_i pi/4}]; qubits past the vector stay |0>."""
    v = _normalize(vectors.to(torch.float32))
    k = min(v.shape[-1], n_qubits)
    vk = v[..., :k]
    theta = vk * math.pi  # ry angle
    phi = vk * (math.pi / 2)  # rz angle
    a0 = torch.cos(theta / 2) * torch.exp(-1j * phi / 2)
    a1 = torch.sin(theta / 2) * torch.exp(1j * phi / 2)
    amps = torch.stack([a0, a1], dim=-1).to(torch.complex64)  # (..., k, 2)
    if k < n_qubits:
        zero_state = torch.zeros(
            amps.shape[:-2] + (n_qubits - k, 2), dtype=torch.complex64, device=amps.device
        )
        zero_state[..., 0] = 1.0
        amps = torch.cat([amps, zero_state], dim=-2)
    return amps


def apply_1q_gate(
    state: torch.Tensor, gate: torch.Tensor, qubit: int, n_qubits: int
) -> torch.Tensor:
    """Apply a 2x2 gate to ``qubit`` of a (..., 2**n) statevector."""
    batch = state.shape[:-1]
    st = state.reshape(batch + (2,) * n_qubits)
    # C-order reshape puts qubit n-1 on the first state axis
    axis = len(batch) + (n_qubits - 1 - qubit)
    st = torch.movedim(st, axis, -1)
    st = torch.einsum("ab,...b->...a", gate.to(state.device, state.dtype), st)
    st = torch.movedim(st, -1, axis)
    return st.reshape(batch + (2 ** n_qubits,))


def apply_cx(
    state: torch.Tensor, control: int, target: int, n_qubits: int
) -> torch.Tensor:
    """Apply CX(control, target) to a (..., 2**n) statevector: the
    control=1 block gets its target axis reversed."""
    batch = state.shape[:-1]
    st = state.reshape(batch + (2,) * n_qubits)
    ax_c = len(batch) + (n_qubits - 1 - control)
    ax_t = len(batch) + (n_qubits - 1 - target)
    st = torch.movedim(st, (ax_c, ax_t), (-2, -1))
    st = torch.stack([st[..., 0, :], torch.flip(st[..., 1, :], dims=(-1,))], dim=-2)
    st = torch.movedim(st, (-2, -1), (ax_c, ax_t))
    return st.reshape(batch + (2 ** n_qubits,))


def encode_statevector(vectors: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """(..., m) real vectors -> (..., 2**n) complex64 statevectors of the
    reference encoding circuit (rotations, then the CX ladder)."""
    amps = encode_product_amplitudes(vectors, n_qubits)  # (..., n, 2)
    batch = amps.shape[:-2]
    # little-endian: qubit n-1 is the most significant index bit, so the
    # product runs from qubit n-1 down to qubit 0
    state = amps[..., n_qubits - 1, :]
    for q in range(n_qubits - 2, -1, -1):
        state = (state[..., :, None] * amps[..., q, :][..., None, :]).reshape(batch + (-1,))
    for i in range(n_qubits - 1):  # the CX ladder, in circuit order
        state = apply_cx(state, i, i + 1, n_qubits)
    return state


def state_fidelity(psi: torch.Tensor, chi: torch.Tensor) -> torch.Tensor:
    """|<psi|chi>|^2 between statevectors, batched over leading dims."""
    inner = torch.sum(torch.conj(psi) * chi, dim=-1)
    return torch.abs(inner) ** 2


def fidelity_statevector(
    query_vec: torch.Tensor, doc_vecs: torch.Tensor, n_qubits: int
) -> torch.Tensor:
    """Fidelity via the full statevector path: (m,) query x (N, m) docs
    -> (N,) float32."""
    psi_q = encode_statevector(query_vec, n_qubits)
    psi_d = encode_statevector(doc_vecs, n_qubits)
    return state_fidelity(psi_q, psi_d).to(torch.float32)


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


def batched_fidelity(
    query_vec: torch.Tensor,
    doc_vecs: torch.Tensor,
    n_qubits: int,
    analytic: bool = True,
) -> torch.Tensor:
    """(m,) query x (N, m) docs -> (N,) fidelity scores, by the product
    form or (``analytic=False``) the full statevector."""
    if analytic:
        return fidelity_analytic(query_vec, doc_vecs, n_qubits)
    return fidelity_statevector(query_vec, doc_vecs, n_qubits)


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


# ----------------------------------------------------------- amplitude mode


def amplitude_encode(vectors: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """Amplitude encoding: the vector, truncated or zero-padded to 2**n
    components and normalized, IS the complex64 statevector."""
    vectors = vectors.to(torch.float32)
    dim = 2 ** n_qubits
    m = vectors.shape[-1]
    v = vectors[..., :dim] if m >= dim else F.pad(vectors, (0, dim - m))
    return _normalize(v).to(torch.complex64)


def amplitude_fidelity(
    query_vec: torch.Tensor, doc_vecs: torch.Tensor, n_qubits: int
) -> torch.Tensor:
    """|<psi_q|psi_d>|^2 under amplitude encoding: for real vectors the
    squared cosine of the truncated, renormalized vectors, one batched
    f32 product.  (m,) x (N, m) -> (N,); (Q, m) x (N, m) -> (Q, N)."""
    q = torch.real(amplitude_encode(query_vec, n_qubits))
    d = torch.real(amplitude_encode(doc_vecs, n_qubits))
    inner = torch.atleast_2d(q) @ d.T
    out = inner * inner
    return out[0] if query_vec.ndim == 1 else out


def swap_test_probability(
    query_vec: torch.Tensor, doc_vecs: torch.Tensor, n_qubits: int
) -> torch.Tensor:
    """P(ancilla = 0) of the swap test = (1 + |<psi_q|psi_d>|^2) / 2,
    exactly, from the amplitude fidelity."""
    return 0.5 * (1.0 + amplitude_fidelity(query_vec, doc_vecs, n_qubits))
