"""Device mesh of one process (PyTorch port of ``qrag_tpu.parallel.mesh``).

The reference's mesh is a ("data", "model") grid of ``jax.Device``s
that one controller drives.  Here it is a (data, model) grid of
``torch.device`` *slots* held by one process: each slot holds its share
of the work, and one device may fill several slots (the CPU tests put 8
shards on ``cpu``, and one card can hold 4).  Axis roles as in the
reference:

  data  — query batches
  model — corpus rows (the "model" of a retrieval engine is the index)

The placement helpers return a (data, model) nested list with one
tensor per slot, each on its slot's device (``Tensor.to`` makes no copy
where the device already holds it).

Several processes (``distributed_init``) are the next slice of the port
(ROADMAP.md, Queue 1): here it raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from qrag_tpu_torch.config import MeshConfig
from qrag_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-process init.  A single-process run (no address) is a
    no-op, as in the reference; several processes are not ported yet
    (ROADMAP.md, Queue 1: torch.distributed process groups)."""
    if coordinator_address is None:
        return
    raise NotImplementedError(
        "multi-process meshes are the next slice of the port (ROADMAP.md, "
        "Queue 1: torch.distributed process groups)"
    )


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of device slots."""

    devices: np.ndarray  # (dp, mp) object array of torch.device
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i, j]


def mesh_devices(
    device: Optional[Union[str, torch.device]] = None, slots: int = 0
) -> List[torch.device]:
    """The devices of ``slots`` mesh slots.  ``device`` None or
    ``cuda``: the CUDA cards, dealt round-robin (raises without CUDA);
    ``cpu`` or ``cuda:i``: every slot on that device.  ``slots`` 0 is
    one slot per card (one for a single device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    n = slots or len(cards)
    return [cards[i % len(cards)] for i in range(n)]


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence[torch.device]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Mesh:
    """Build the (data, model) mesh.

    data_parallel / model_parallel semantics: -1 means "all remaining
    slots on this axis"; both -1 puts everything on "model".  Without
    ``devices``, an explicit dp x mp grid takes that many slots on
    ``device`` (``mesh_devices``), and a grid with a -1 takes one slot
    per card."""
    config = config or MeshConfig()
    dp, mp = config.data_parallel, config.model_parallel
    if devices is None:
        slots = dp * mp if dp > 0 and mp > 0 else 0
        devices = mesh_devices(device, slots)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp == -1 and mp == -1:
        dp, mp = 1, n
    elif dp == -1:
        dp = n // mp
    elif mp == -1:
        mp = n // dp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} does not cover {n} devices")
    arr = np.empty((dp, mp), dtype=object)
    for s, d in enumerate(devices):
        arr[s // mp, s % mp] = d
    return Mesh(arr, (config.data_axis, config.model_axis))


def _grid(mesh: Mesh, part) -> List[List[torch.Tensor]]:
    dp, mp = mesh.devices.shape
    return [[part(i, j).to(mesh.device(i, j)) for j in range(mp)] for i in range(dp)]


def replicated(mesh: Mesh, t: torch.Tensor) -> List[List[torch.Tensor]]:
    """``t`` on every slot."""
    return _grid(mesh, lambda i, j: t)


def row_sharded(mesh: Mesh, t: torch.Tensor) -> List[List[torch.Tensor]]:
    """``t``'s rows split in equal blocks over the model axis (each
    block on every slot of its column); rows % model size == 0."""
    mp = mesh.devices.shape[1]
    rows = t.shape[0] // mp
    return _grid(mesh, lambda i, j: t[j * rows : (j + 1) * rows])


def batch_sharded(mesh: Mesh, t: torch.Tensor) -> List[List[torch.Tensor]]:
    """``t``'s leading (batch) axis split in equal blocks over the data
    axis (each block on every slot of its row); B % data size == 0."""
    dp = mesh.devices.shape[0]
    rows = t.shape[0] // dp
    return _grid(mesh, lambda i, j: t[i * rows : (i + 1) * rows])
