"""Minimal quantum circuit API over the batched statevector ops
(PyTorch port of ``qrag_tpu.ops.circuit``).

The reference builds its encoding with Qiskit's ``QuantumCircuit``
(ry/rz/cx).  Here gates append to a program and ``simulate`` folds them
over ``ops.statevector``'s ``apply_1q_gate`` / ``apply_cx`` on
``torch.complex64`` states, so circuit variants (other entanglers,
extra layers, Hadamard-test probes) need no Qiskit.  Gates follow
Qiskit's conventions (little-endian; RY/RZ/H/X/Z/CX as in
``tests/oracle_qiskit.py``); a batched initial state simulates a batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.ops.statevector import apply_1q_gate, apply_cx

_SQRT1_2 = 1.0 / math.sqrt(2.0)


def _gate(rows) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.complex64)


def _ry(theta: float) -> torch.Tensor:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return _gate([[c, -s], [s, c]])


def _rz(phi: float) -> torch.Tensor:
    return _gate([[complex(math.cos(phi / 2), -math.sin(phi / 2)), 0],
                  [0, complex(math.cos(phi / 2), math.sin(phi / 2))]])


_H = _gate([[_SQRT1_2, _SQRT1_2], [_SQRT1_2, -_SQRT1_2]])
_X = _gate([[0, 1], [1, 0]])
_Z = _gate([[1, 0], [0, -1]])


@dataclass
class Circuit:
    """Gate program on ``n_qubits`` (Qiskit-convention semantics).  The
    default |0...0> state lives on ``device`` (the card unless the
    caller asks for the CPU); a given state keeps its own device."""

    n_qubits: int
    device: Optional[str] = None
    _ops: List[Tuple] = field(default_factory=list)

    # -- construction (chainable) --------------------------------------

    def ry(self, theta: float, qubit: int) -> "Circuit":
        self._ops.append(("1q", _ry(theta), qubit))
        return self

    def rz(self, phi: float, qubit: int) -> "Circuit":
        self._ops.append(("1q", _rz(phi), qubit))
        return self

    def h(self, qubit: int) -> "Circuit":
        self._ops.append(("1q", _H, qubit))
        return self

    def x(self, qubit: int) -> "Circuit":
        self._ops.append(("1q", _X, qubit))
        return self

    def z(self, qubit: int) -> "Circuit":
        self._ops.append(("1q", _Z, qubit))
        return self

    def gate(self, matrix, qubit: int) -> "Circuit":
        """Arbitrary 2x2 unitary."""
        self._ops.append(("1q", torch.as_tensor(np.asarray(matrix), dtype=torch.complex64), qubit))
        return self

    def cx(self, control: int, target: int) -> "Circuit":
        self._ops.append(("cx", control, target))
        return self

    def cx_ladder(self) -> "Circuit":
        """The reference's entangler: cx(i, i+1) for all i."""
        for i in range(self.n_qubits - 1):
            self.cx(i, i + 1)
        return self

    def encode_rotations(self, vector) -> "Circuit":
        """The reference's data encoding: ry(v_i pi) then rz(v_i pi/2)
        on qubit i for the first min(len(v), n) NORMALIZED components."""
        v = np.asarray(vector, np.float64)
        norm = np.linalg.norm(v)
        if norm > 0:
            v = v / norm
        for i in range(min(len(v), self.n_qubits)):
            self.ry(float(v[i]) * math.pi, i)
            self.rz(float(v[i]) * math.pi / 2, i)
        return self

    # -- simulation ----------------------------------------------------

    def simulate(self, state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Statevector after the program; batched over leading dims of
        ``state`` when given ((..., 2**n); defaults to |0...0>)."""
        n = self.n_qubits
        if state is None:
            state = torch.zeros((2 ** n,), dtype=torch.complex64, device=resolve_device(self.device))
            state[0] = 1.0
        for op in self._ops:
            if op[0] == "1q":
                _, u, q = op
                state = apply_1q_gate(state, u, q, n)
            else:
                _, c, t = op
                state = apply_cx(state, c, t, n)
        return state

    def probabilities(self, state: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.abs(self.simulate(state)) ** 2

    def measure_probability(
        self, qubit: int, value: int = 1, state: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """P(measuring ``qubit`` = value)."""
        probs = self.probabilities(state)
        idx = torch.arange(2 ** self.n_qubits, device=probs.device)
        mask = ((idx >> qubit) & 1) == value
        return torch.sum(torch.where(mask, probs, 0.0), dim=-1)
