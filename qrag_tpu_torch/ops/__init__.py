"""Ops of the port: plain-torch ops and the CUDA kernels' wrappers
(``ops/cuda/``, which build their kernels at first launch, never at
import)."""

from qrag_tpu_torch.ops.statevector import (
    apply_1q_gate,
    apply_cx,
    batched_fidelity,
    encode_product_amplitudes,
    encode_statevector,
    fidelity_analytic,
    fidelity_statevector,
    state_fidelity,
)
from qrag_tpu_torch.ops.topk import cosine_scores, flat_scan_topk, ip_topk, l2_topk

__all__ = [
    "encode_statevector",
    "encode_product_amplitudes",
    "apply_cx",
    "apply_1q_gate",
    "state_fidelity",
    "fidelity_statevector",
    "fidelity_analytic",
    "batched_fidelity",
    "l2_topk",
    "ip_topk",
    "cosine_scores",
    "flat_scan_topk",
]
