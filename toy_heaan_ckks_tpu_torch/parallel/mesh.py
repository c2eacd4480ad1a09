"""The coefficient mesh: a ring's coefficient axis split over P shards.

Counterpart of the coefficient part of ``toy_heaan_ckks_tpu/parallel/mesh.py``
and of how the reference lays a plane out on it: a ``Mesh(devices,
axis_names=("coeff",))`` and ``NamedSharding(P(None, None, "coeff"))``,
which put P contiguous slabs of S = N / P coefficients of every plane
(..., L, N) on the P devices in order. Here a ``CoeffMesh`` holds the P
shard devices, and a sharded value is the tuple of its P slab tensors
(..., L, S), slab p on ``mesh.devices[p]``: ``shard_planes`` makes one from
a whole plane (the reference's ``device_put``) and ``unshard_planes`` joins
it again. On one card every shard is that card. Shards on several cards
need peer access between every pair (a K11 stage reads its partner slab in
place); nothing is copied between cards behind the caller's back. The
batch x channel mesh (``make_ckks_mesh``, ``ct_spec``, ``key_spec``) is not
ported here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..context import canonical_device


@dataclasses.dataclass(frozen=True)
class CoeffMesh:
    """The P shard devices of a coefficient mesh, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def shards(self) -> int:
        return len(self.devices)

    def check(self, slabs) -> tuple:
        """``slabs`` as a tuple, after checking that there is one per shard,
        each on its shard's device."""
        slabs = tuple(slabs)
        if len(slabs) != self.shards:
            raise ValueError(f"{len(slabs)} slabs on a mesh of {self.shards} shards")
        for p, (t, dev) in enumerate(zip(slabs, self.devices)):
            if t.device != dev:
                raise ValueError(f"slab {p} on {t.device}, its shard is {dev}")
        return slabs


def make_coeff_mesh(shards: int, device=None) -> CoeffMesh:
    """A mesh of ``shards`` (a power of two) shards. ``device``: one device
    for every shard (default: the current CUDA device, raising where there
    is none, as ``context.canonical_device``), or a sequence of ``shards``
    devices. Shards on several CUDA devices need
    ``torch.cuda.can_device_access_peer`` between every pair; a mesh mixing
    the CPU and CUDA is refused."""
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"a coefficient mesh needs a power-of-two shard "
                         f"count, got {shards}")
    if device is None or isinstance(device, (str, torch.device)):
        devices = (canonical_device(device),) * shards
    else:
        devices = tuple(canonical_device(d) for d in device)
        if len(devices) != shards:
            raise ValueError(f"{len(devices)} devices for {shards} shards")
    kinds = {d.type for d in devices}
    if len(kinds) > 1:
        raise ValueError(f"a coefficient mesh on {sorted(kinds)}: one kind only")
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise ValueError(f"cuda:{a} cannot access cuda:{b}'s memory")
    return CoeffMesh(devices)


def shard_planes(x: torch.Tensor, mesh: CoeffMesh) -> tuple:
    """The P contiguous slabs (..., S) of ``x`` (..., N), slab p on shard
    p's device."""
    n = x.shape[-1]
    if n % mesh.shards:
        raise ValueError(f"N = {n} does not split into {mesh.shards} shards")
    s = n // mesh.shards
    return tuple(x[..., p * s : (p + 1) * s].to(dev).contiguous()
                 for p, dev in enumerate(mesh.devices))


def unshard_planes(slabs) -> torch.Tensor:
    """The whole plane (..., N) of P slabs, on the first slab's device."""
    slabs = tuple(slabs)
    return torch.cat([t.to(slabs[0].device) for t in slabs], dim=-1)
