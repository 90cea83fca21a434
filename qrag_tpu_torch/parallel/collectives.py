"""The port's collectives over a mesh (no namesake in the reference: XLA
inserts its collectives, here they are written out).

Two families:

* over a mesh's slots (the sharded index): ``all_gather``,
  ``all_reduce`` (sum), ``broadcast`` and ``ring_shift`` (every slot
  sends its set to the next slot of its model-axis ring and receives the
  previous one's: the reference's ``ppermute``).  Slots of this rank
  combine in-process (``Tensor.to``); other ranks' go through
  ``torch.distributed`` over ``mesh.group``.  A mesh of one process
  (``group`` None) makes no call to ``torch.distributed``.
* over one axis of a mesh with one slot a rank (the trainer and sequence
  parallelism): ``axis_groups`` makes the process groups of this rank's
  data row and model column, ``all_reduce_axis`` / ``all_gather_axis``
  run on them, and three ``torch.autograd.Function``s carry gradients
  across them: Megatron's *f* (``copy_to_model``: identity forward,
  all-reduce backward) and *g* (``reduce_from_model``: all-reduce
  forward, identity backward), and ``gather_tokens`` (an all-gather
  along the token axis whose backward keeps this rank's slice of the
  gradient summed over the axis).  ``torch.distributed.nn.functional``'s
  ``all_reduce`` is not used: its backward all-reduces again, which
  would count a tensor-parallel gradient once per model rank.

On gloo every collective here stages through host tensors (a copy each
way), one path for all of them: gloo's all-reduce, broadcast and (seen
on the H100 host, torch 2.11) all-gather also take device tensors,
copying through the host themselves, and its point-to-point sends were
not tried with device tensors.  NCCL takes the device tensors as they
are.
A collective that fails or times out raises (the group's timeout is
``distributed_init``'s).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from qrag_tpu_torch.parallel.mesh import Mesh

Slot = Tuple[int, int]


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _out(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective on ``group`` runs on: a host copy of a
    device tensor on gloo, else ``t`` (contiguous)."""
    if _staged(group) and t.device.type != "cpu":
        return t.detach().to("cpu").contiguous()
    return t.contiguous()


# ------------------------------------------------------------ over slots


def _in_place(t: torch.Tensor, group, collective) -> torch.Tensor:
    """``collective(buf)`` on a fresh copy of ``t`` (on the host on
    gloo), the result back on ``t``'s device; ``t`` itself without a
    group."""
    if group is None:
        return t
    buf = _out(t, group)
    if buf is t:
        buf = t.clone()
    collective(buf)
    return buf.to(t.device)


def all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t`` (each rank has summed its own
    slots' share into it); ``t`` itself in one process."""
    return _in_place(t, mesh.group, lambda b: dist.all_reduce(b, group=mesh.group))


def broadcast(mesh: Mesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (each passes a tensor of the
    same shape and dtype); ``t`` itself in one process."""
    return _in_place(t, mesh.group, lambda b: dist.broadcast(b, src, group=mesh.group))


def all_gather(
    mesh: Mesh, parts: Dict[Slot, torch.Tensor], device: torch.device
) -> Dict[Slot, torch.Tensor]:
    """Every slot's tensor on ``device``, from each rank's own
    ``parts`` (one tensor a local slot, all of one shape and dtype)."""
    if mesh.group is None:
        return {s: t.to(device) for s, t in parts.items()}
    local = mesh.local_slots()
    stacked = _out(torch.stack([parts[s] for s in local]), mesh.group)
    bufs = [torch.empty_like(stacked) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(bufs, stacked, group=mesh.group)
    dp, mp = mesh.devices.shape
    seen: Dict[int, int] = {}
    out = {}
    for i in range(dp):
        for j in range(mp):
            r = mesh.rank(i, j)
            out[(i, j)] = bufs[r][seen.get(r, 0)].to(device)
            seen[r] = seen.get(r, 0) + 1
    return out


def ring_shift(
    mesh: Mesh, trav: Dict[Slot, Tuple[torch.Tensor, ...]]
) -> Dict[Slot, Tuple[torch.Tensor, ...]]:
    """One step of the model-axis ring: slot (i, j) receives slot
    (i, j-1)'s tuple (on its own device) as slot (i, j+1) receives its
    one.  Between ranks the sends and receives go out as one batch of
    point-to-point operations, so no rank blocks on a send; messages
    between two ranks are issued in the order of their destination
    slot on both sides."""
    mp = mesh.devices.shape[1]
    out: Dict[Slot, Tuple[torch.Tensor, ...]] = {}
    ops, landing = [], []
    group = mesh.group
    for i, j in mesh.local_slots():
        src = (i, (j - 1) % mp)
        if mesh.is_local(*src):
            out[(i, j)] = tuple(t.to(mesh.device(i, j)) for t in trav[src])
            continue
        host = "cpu" if _staged(group) else None
        bufs = tuple(torch.empty_like(t, device=host) for t in trav[(i, j)])
        ops += [dist.P2POp(dist.irecv, b, mesh.rank(*src), group, tag=2 * (i * mp + j) + n)
                for n, b in enumerate(bufs)]
        landing.append(((i, j), bufs))
    for i, j in sorted(mesh.local_slots(), key=lambda s: (s[0], (s[1] + 1) % mp)):
        dst = (i, (j + 1) % mp)
        if mesh.is_local(*dst):
            continue
        tag = 2 * (i * mp + dst[1])
        ops += [dist.P2POp(dist.isend, _out(t, group), mesh.rank(*dst), group, tag=tag + n)
                for n, t in enumerate(trav[(i, j)])]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for slot, bufs in landing:
        out[slot] = tuple(b.to(mesh.device(*slot)) for b in bufs)
    return out


# ------------------------------------------------------------ over an axis


@dataclass(frozen=True)
class Axis:
    """This rank's place on one mesh axis: the process group of the
    ranks that share its other coordinate (None when the axis has one
    member), the axis's size and this rank's index on it."""

    group: Optional[object]
    size: int
    index: int


# (dp, mp, ranks) -> this rank's axes: a layout's groups are made once
# per process group (``mesh.shutdown`` forgets them with the group)
_AXES: Dict[tuple, Tuple[Axis, Axis]] = {}


def axis_groups(mesh: Mesh) -> Tuple[Axis, Axis]:
    """(data axis, model axis) of this rank on ``mesh``, which must hold
    exactly one slot a rank.  The first call for a layout makes every
    row's and column's group on every rank of the mesh's group, in one
    order (``new_group`` is collective: every rank calls it alike);
    later calls reuse them."""
    dp, mp = mesh.devices.shape
    key = (dp, mp, None if mesh.ranks is None else tuple(mesh.ranks.flat), mesh.group is None)
    if key not in _AXES:
        _AXES[key] = _make_axes(mesh)
    return _AXES[key]


def _make_axes(mesh: Mesh) -> Tuple[Axis, Axis]:
    dp, mp = mesh.devices.shape
    local = mesh.local_slots()
    if len(local) != 1:
        raise ValueError(f"an axis collective needs one slot a rank; this rank holds {local}")
    (i, j), = local
    if mesh.group is None:
        if dp * mp != 1:
            raise ValueError(f"a {dp}x{mp} mesh of one process has no axis groups")
        return Axis(None, 1, 0), Axis(None, 1, 0)
    ranks = [[mesh.rank(a, b) for b in range(mp)] for a in range(dp)]
    rows = [dist.new_group(ranks[a]) if mp > 1 else None for a in range(dp)]
    cols = [dist.new_group([ranks[a][b] for a in range(dp)]) if dp > 1 else None
            for b in range(mp)]
    return Axis(cols[j], dp, i), Axis(rows[i], mp, j)


def all_reduce_axis(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over the axis (a new tensor)."""
    return _in_place(t, axis.group, lambda b: dist.all_reduce(b, group=axis.group))


def all_gather_axis(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The axis members' ``t`` concatenated along ``dim`` in axis order."""
    if axis.group is None:
        return t
    buf = _out(t, axis.group)
    bufs = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(bufs, buf, group=axis.group)
    return torch.cat([b.to(t.device) for b in bufs], dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_axis(grad, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_axis(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return all_gather_axis(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_axis(grad.contiguous(), ctx.axis)
        return total.narrow(ctx.dim, ctx.axis.index * ctx.width, ctx.width), None, None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """*f*: ``x`` as it is; its gradient summed over the model axis (the
    input of a column-parallel layer, whose ranks each see a part of
    the gradient of a replicated tensor)."""
    return x if axis.group is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """*g*: the sum of every model rank's ``x`` (the partial output of a
    row-parallel layer); its gradient passes as it is."""
    return x if axis.group is None else _ReduceFromModel.apply(x, axis)


def gather_tokens(x: torch.Tensor, axis: Axis, dim: int = 1) -> torch.Tensor:
    """Every model rank's block of the token axis ``dim``, concatenated;
    the backward sums the gradient over the axis and keeps this rank's
    block."""
    return x if axis.group is None else _GatherTokens.apply(x, axis, dim)


__all__ = [
    "Axis",
    "all_gather",
    "all_gather_axis",
    "all_reduce",
    "all_reduce_axis",
    "axis_groups",
    "broadcast",
    "copy_to_model",
    "gather_tokens",
    "reduce_from_model",
    "ring_shift",
]
