"""The batch x channel mesh's collectives, over one mesh axis.

The reference leaves them to XLA, which inserts them where its
``NamedSharding`` annotations need them (``parallel/sharded.py:1-12``,
``parallel/mesh.py:1-18``): the all-gather of the plain digit residues of
the gadget decomposition, the sum of the digit products over the channel
axis, and the broadcast of the dropped channel of the rescale. Here each
is a named function over a mesh axis, run in one process over the grid's
devices, as the coefficient mesh runs its stages: a value is one tensor
per grid point (``parts[i]`` on ``mesh.points[i]``), and a collective
returns one per point. Each group of points along the axis forms its
result once per distinct device among its points and hands it to every
point on that device, so on one card nothing is copied and across cards
each block crosses by a peer copy (``.to(device)``). Modular addition is
exact, so a sum in any order gives the same words.
"""

from __future__ import annotations

import torch

from ..ops import modular as mm
from .mesh import Mesh


def _per_device(mesh: Mesh, axis: str, form) -> list:
    """For each group along ``axis``, ``form(group, device)`` once per
    distinct device of the group, handed to each of its points."""
    out = [None] * mesh.size
    for group in mesh.groups(axis):
        made = {}
        for p in group:
            dev = mesh.points[p]
            if dev not in made:
                made[dev] = form(group, dev)
            out[p] = made[dev]
    return out


def all_gather(mesh: Mesh, parts, axis: str = "channel", dim: int = -2) -> list:
    """Each point gets its group's parts joined along ``dim`` in the axis's
    order (parts may be empty along ``dim``)."""
    return _per_device(mesh, axis, lambda group, dev: torch.cat(
        [parts[p].to(dev) for p in group], dim=dim))


def sum_mod(mesh: Mesh, parts, q: torch.Tensor, axis: str = "channel") -> list:
    """Each point gets the sum mod ``q`` (a column broadcasting against the
    parts) of its group's parts; a point may hold None (nothing to add),
    but every group must hold a part."""

    def form(group, dev):
        qd = q.to(dev)
        acc = None
        for p in group:
            if parts[p] is not None:
                x = parts[p].to(dev)
                acc = x if acc is None else mm.add_mod(acc, x, qd)
        if acc is None:
            raise ValueError("sum_mod: a group with no part")
        return acc

    return _per_device(mesh, axis, form)


def broadcast(mesh: Mesh, parts, src: int, axis: str = "channel") -> list:
    """Each point gets the part of the point at index ``src`` of its group
    along ``axis``."""
    return _per_device(mesh, axis, lambda group, dev: parts[group[src]].to(dev))
