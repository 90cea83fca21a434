"""Device mesh and multi-process init (PyTorch port of
``qrag_tpu.parallel.mesh``).

The reference's mesh is a ("data", "model") grid of ``jax.Device``s;
after ``jax.distributed.initialize`` it spans every process, and each
process drives the devices it can address.  Here it is a (data, model)
grid of ``torch.device`` *slots*, each owned by one rank of a
``torch.distributed`` process group: a rank drives its own slots and
reaches the others' through the collectives of ``collectives.py``.  One
device may fill several slots (the CPU tests put 8 shards on ``cpu``,
and one card can hold 4), and a rank may hold several slots.  Axis
roles as in the reference:

  data  — query batches (DP) and training batches
  model — corpus rows (the "model" of a retrieval engine is the index),
          attention heads / FFN hidden (TP), experts (EP), and the
          token axis under sequence parallelism

The placement helpers return a (data, model) nested list with one
tensor per slot, each on its slot's device (``Tensor.to`` makes no copy
where the device already holds it), and None for a slot another rank
owns: a rank uploads only its own slots' share.

``distributed_init`` joins a process group (gloo or NCCL) and starts a
heartbeat that ``elastic.py`` reads to tell a dead rank from a live one.
Without it (one process) the mesh holds only this process's slots, uses
no collective, and behaves exactly as before several processes were
ported.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from qrag_tpu_torch.config import MeshConfig
from qrag_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"

# a collective that waits on a dead peer raises after this long, not
# after torch's default 30 minutes
TIMEOUT_S = 60.0
# the heartbeat's period; a rank whose counter did not move over
# HEARTBEAT_WAIT_S is dead
HEARTBEAT_PERIOD_S = 0.2
HEARTBEAT_WAIT_S = 1.0
_HEARTBEAT_KEY = "qrag_heartbeat/{}"


@dataclass
class _Process:
    rank: int
    world: int
    device: torch.device
    backend: str
    store: object
    stop: threading.Event
    heartbeat: threading.Thread


_PROCESS: Optional[_Process] = None


def _init_url(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``, ``env://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def _heartbeat(store, rank: int, stop: threading.Event) -> None:
    key = _HEARTBEAT_KEY.format(rank)
    while not stop.wait(HEARTBEAT_PERIOD_S):
        store.add(key, 1)  # raises, ending the thread, once the store's host is gone


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> None:
    """Join the process group (the reference's
    ``jax.distributed.initialize``).  No-op without an address, as in
    the reference.

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous, rank 0
    hosts the store), or a URL: ``file:///path`` (a shared file, as the
    tests use), ``env://`` (``torchrun``'s ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``; ``num_processes`` and
    ``process_id`` may then be None).  The rendezvous is made here and
    its store handed to ``init_process_group``, so that this process
    keeps it for the heartbeat.  ``backend`` None is ``nccl``, or
    ``gloo`` when ``device`` is ``cpu``.  This rank's device is ``cpu``,
    or ``cuda:<local rank % device count>`` (``LOCAL_RANK`` when set,
    else the rank); without CUDA a CUDA device raises.  Every
    collective of the group raises after ``TIMEOUT_S``."""
    global _PROCESS
    if coordinator_address is None:
        return
    if _PROCESS is not None:
        raise RuntimeError("distributed_init: this process already joined a group")
    want = resolve_device(device)
    backend = backend or ("gloo" if want.type == "cpu" else "nccl")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and want.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    url = _init_url(coordinator_address)
    store, rank, world = next(dist.rendezvous(
        url, rank=-1 if process_id is None else int(process_id),
        world_size=-1 if num_processes is None else int(num_processes), timeout=timeout,
    ))
    store.set_timeout(timeout)
    if want.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        want = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(want)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout)
    stop = threading.Event()
    beat = threading.Thread(target=_heartbeat, args=(store, rank, stop), daemon=True,
                            name=f"qrag-heartbeat-{rank}")
    _PROCESS = _Process(rank, world, want, backend, store, stop, beat)
    beat.start()
    # at exit the beat stops before the store is torn down under a call
    # it has in flight
    atexit.register(_stop_heartbeat, _PROCESS)
    logger.info("joined %s group: rank %d/%d on %s", backend, rank, world, want)


def process_index() -> int:
    """This process's rank (``jax.process_index``); 0 without a group."""
    return _PROCESS.rank if _PROCESS is not None else 0


def process_count() -> int:
    """The number of processes (``jax.process_count``); 1 without a group."""
    return _PROCESS.world if _PROCESS is not None else 1


def local_device() -> Optional[torch.device]:
    """The device ``distributed_init`` gave this rank (None without a
    group)."""
    return _PROCESS.device if _PROCESS is not None else None


def peers_alive(ranks: Sequence[int]) -> Dict[int, bool]:
    """{rank: did its heartbeat counter move over ``HEARTBEAT_WAIT_S``?}
    for every rank of ``ranks``, read over one wait.  Reads the
    rendezvous store; raises if the store itself is unreachable (its
    host is gone)."""
    if _PROCESS is None:
        raise RuntimeError("peers_alive: no process group (distributed_init)")
    keys = {r: _HEARTBEAT_KEY.format(r) for r in ranks}
    before = {r: _PROCESS.store.add(key, 0) for r, key in keys.items()}
    time.sleep(HEARTBEAT_WAIT_S)
    return {r: _PROCESS.store.add(key, 0) > before[r] for r, key in keys.items()}


def _stop_heartbeat(proc: _Process) -> None:
    proc.stop.set()
    proc.heartbeat.join(timeout=5 * HEARTBEAT_PERIOD_S)


def shutdown() -> None:
    """Stop the heartbeat and leave the group.  Never call it on a
    group that lost a peer: the teardown may wait on the dead rank."""
    global _PROCESS
    if _PROCESS is None:
        return
    from qrag_tpu_torch.parallel import collectives

    _stop_heartbeat(_PROCESS)
    collectives._AXES.clear()  # their groups go with the default one
    dist.destroy_process_group()
    _PROCESS = None


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of device slots.  ``ranks`` holds each
    slot's owning rank; ``group`` is the process group the mesh's
    collectives run over (None: one process, no collective)."""

    devices: np.ndarray  # (dp, mp) object array of torch.device
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)
    ranks: Optional[np.ndarray] = None  # (dp, mp) int; None: all this rank's
    group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i, j]

    def rank(self, i: int, j: int) -> int:
        return process_index() if self.ranks is None else int(self.ranks[i, j])

    def is_local(self, i: int, j: int) -> bool:
        return self.rank(i, j) == process_index()

    def local_slots(self) -> List[Tuple[int, int]]:
        """This rank's slots (i, j), in slot order."""
        dp, mp = self.devices.shape
        return [(i, j) for i in range(dp) for j in range(mp) if self.is_local(i, j)]

    @property
    def spans_processes(self) -> bool:
        return self.group is not None


def mesh_devices(
    device: Optional[Union[str, torch.device]] = None, slots: int = 0
) -> List[torch.device]:
    """The devices of ``slots`` mesh slots of this process.  ``device``
    None or ``cuda``: the CUDA cards, dealt round-robin (raises without
    CUDA) — after ``distributed_init``, the device it gave this rank;
    ``cpu`` or ``cuda:i``: every slot on that device.  ``slots`` 0 is
    one slot per card (one for a single device)."""
    if device is None and _PROCESS is not None:
        device = _PROCESS.device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if _PROCESS is not None and _PROCESS.device.type == "cuda":
            cards = [_PROCESS.device]
        else:
            cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    n = slots or len(cards)
    return [cards[i % len(cards)] for i in range(n)]


def _group_devices(local: List[torch.device]) -> Tuple[List[torch.device], List[int]]:
    """Every rank's slot devices in rank order (as ``jax.devices()``
    orders global devices), and each slot's rank: one
    ``all_gather_object`` over the group."""
    per_rank: List[Optional[List[str]]] = [None] * process_count()
    dist.all_gather_object(per_rank, [str(d) for d in local])
    counts = {len(p) for p in per_rank}
    if len(counts) != 1:
        raise ValueError(f"ranks hold unequal slot counts {[len(p) for p in per_rank]}")
    devices = [torch.device(d) for p in per_rank for d in p]
    ranks = [r for r, p in enumerate(per_rank) for _ in p]
    return devices, ranks


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence[torch.device]] = None,
    device: Optional[Union[str, torch.device]] = None,
    ranks: Optional[Sequence[int]] = None,
    group: Optional[object] = None,
) -> Mesh:
    """Build the (data, model) mesh.

    data_parallel / model_parallel semantics: -1 means "all remaining
    slots on this axis"; both -1 puts everything on "model".

    Without ``devices``: in one process, an explicit dp x mp grid takes
    that many slots on ``device`` (``mesh_devices``) and a grid with a
    -1 one slot per card.  After ``distributed_init``, every rank
    contributes dp*mp / world slots (a -1 grid: one a rank) and the
    mesh lays them out in rank order over the whole group, so slot s
    belongs to rank ``s // (dp*mp / world)``.  With ``devices``, the
    slots are those (``ranks`` gives their owners, default this rank;
    ``group`` the process group of their collectives, default none)."""
    config = config or MeshConfig()
    dp, mp = config.data_parallel, config.model_parallel
    if devices is None:
        slots = dp * mp if dp > 0 and mp > 0 else 0
        if _PROCESS is not None:
            world = process_count()
            if slots % world:
                raise ValueError(f"mesh {dp}x{mp} does not split over {world} processes")
            devices, ranks = _group_devices(mesh_devices(device, slots // world or 1))
            group = dist.group.WORLD
        else:
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
    rank_arr = None
    if ranks is not None:
        if len(ranks) != n:
            raise ValueError(f"{len(ranks)} ranks for {n} slots")
        rank_arr = np.asarray(ranks, dtype=np.int64).reshape(dp, mp)
    return Mesh(arr, (config.data_axis, config.model_axis), rank_arr, group)


def _grid(mesh: Mesh, part) -> List[List[Optional[torch.Tensor]]]:
    dp, mp = mesh.devices.shape
    return [
        [part(i, j).to(mesh.device(i, j)) if mesh.is_local(i, j) else None for j in range(mp)]
        for i in range(dp)
    ]


def replicated(mesh: Mesh, t: torch.Tensor) -> List[List[Optional[torch.Tensor]]]:
    """``t`` on every slot of this rank."""
    return _grid(mesh, lambda i, j: t)


def row_sharded(mesh: Mesh, t: torch.Tensor) -> List[List[Optional[torch.Tensor]]]:
    """``t``'s rows split in equal blocks over the model axis (each
    block on every slot of its column that this rank owns); rows %
    model size == 0."""
    mp = mesh.devices.shape[1]
    rows = t.shape[0] // mp
    return _grid(mesh, lambda i, j: t[j * rows : (j + 1) * rows])


def batch_sharded(mesh: Mesh, t: torch.Tensor) -> List[List[Optional[torch.Tensor]]]:
    """``t``'s leading (batch) axis split in equal blocks over the data
    axis (each block on every slot of its row that this rank owns);
    B % data size == 0."""
    dp = mesh.devices.shape[0]
    rows = t.shape[0] // dp
    return _grid(mesh, lambda i, j: t[i * rows : (i + 1) * rows])
