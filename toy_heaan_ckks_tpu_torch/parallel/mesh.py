"""Device meshes: the batch x channel mesh and the coefficient mesh.

Counterpart of ``toy_heaan_ckks_tpu/parallel/mesh.py``.

The batch x channel mesh (``make_ckks_mesh``, ``make_multihost_mesh``) is a
grid of devices with named axes, as the reference's ``Mesh``: ``batch``
splits independent ciphertexts, ``channel`` the RNS residue channels (and
a gadget key's digits), ``host`` (multihost) only the batch. A
``ShardSpec`` says which mesh axes, if any, split each array axis: the
reference's ``NamedSharding(mesh, PartitionSpec(...))`` without its limb
axis (planes are (B, L, N) and keys (D, E, N) here, (B, L, 2, N) and
(D, E, 2, N) there). ``shard`` turns a whole tensor into a ``Sharded``
value, the grid of its blocks each on its grid point's device (the
reference's ``jax.device_put``), and ``unshard`` gives the whole tensor
back (its ``np.asarray``). A mesh axis that does not divide an array axis
cannot split it: ``shard`` raises ``ValueError`` where the reference's
``device_put`` fails, and ``ct_spec_for`` / ``key_spec_for`` replicate such
an axis instead, as the reference's do. The collectives that XLA inserts
for the reference are explicit functions over a mesh axis
(``parallel/collectives.py``), run in one process over the grid's devices.

The coefficient mesh: the reference's ``Mesh(devices, axis_names=
("coeff",))`` and ``NamedSharding(P(None, None, "coeff"))`` put P
contiguous slabs of S = N / P coefficients of every plane (..., L, N) on
the P devices in order. Here a ``CoeffMesh`` holds the P shard devices,
and a sharded value is the tuple of its P slab tensors (..., L, S), slab p
on ``mesh.devices[p]``: ``shard_planes`` makes one from a whole plane and
``unshard_planes`` joins it again.

On one card every grid point or shard is that card. Points on several
cards need peer access between every pair (a K11 stage reads its partner
slab in place, a collective copies blocks card to card); nothing is
copied between cards behind the caller's back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..context import canonical_device


def _grid_devices(device, count: int) -> tuple:
    """``count`` devices: ``device`` (one device, default the current CUDA
    device, raising where there is none) for each, or the first ``count``
    of a sequence. Refuses a grid mixing the CPU and CUDA, and cards
    without peer access between every pair."""
    if device is None or isinstance(device, (str, torch.device)):
        devices = (canonical_device(device),) * count
    else:
        devices = tuple(canonical_device(d) for d in device)
        if len(devices) < count:
            raise ValueError(f"need {count} devices, have {len(devices)}")
        devices = devices[:count]
    kinds = {d.type for d in devices}
    if len(kinds) > 1:
        raise ValueError(f"a mesh on {sorted(kinds)}: one kind only")
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise ValueError(f"cuda:{a} cannot access cuda:{b}'s memory")
    return devices


# ── the batch x channel mesh ─────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes; grid points are numbered in
    row-major order, ``points[i]`` the device of point i."""

    axis_names: tuple[str, ...]
    grid: tuple[int, ...]
    points: tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        """Axis name -> size, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def devices(self) -> np.ndarray:
        """The devices as an object array of the grid's shape."""
        arr = np.empty(len(self.points), dtype=object)
        arr[:] = self.points
        return arr.reshape(self.grid)

    @property
    def size(self) -> int:
        return len(self.points)

    def coords(self, point: int) -> dict:
        """Axis name -> the point's index along it."""
        return dict(zip(self.axis_names, np.unravel_index(point, self.grid)))

    def groups(self, axis: str) -> list:
        """The points that differ only along ``axis``, each group in the
        axis's order."""
        k = self.axis_names.index(axis)
        index = np.arange(self.size).reshape(self.grid)
        moved = np.moveaxis(index, k, -1).reshape(-1, self.grid[k])
        return [tuple(int(p) for p in row) for row in moved]


def make_ckks_mesh(n_devices: int | None = None, batch: int = 1,
                   devices=None) -> Mesh:
    """A (batch, channel) mesh of ``n_devices`` grid points. ``devices``:
    one device for every point (default: the current CUDA device, raising
    where there is none) or a sequence whose first ``n_devices`` are the
    points, in order; ``n_devices`` defaults to the sequence's length, or
    to 1 for one device."""
    if n_devices is None:
        single = devices is None or isinstance(devices, (str, torch.device))
        n_devices = 1 if single else len(devices)
    if batch < 1 or n_devices % batch:
        raise ValueError("batch axis size must divide device count")
    return Mesh(("batch", "channel"), (batch, n_devices // batch),
                _grid_devices(devices, n_devices))


def make_multihost_mesh(hosts: int | None = None,
                        chips_per_host: int | None = None,
                        batch_per_host: int = 1, devices=None) -> Mesh:
    """A (host, batch, channel) mesh. The host axis carries only the batch
    (independent ciphertexts never talk across hosts); within a host the
    axes are ``make_ckks_mesh``'s. ``hosts`` defaults to the process
    group's size, 1 without one (the port drives every point from one
    process); ``chips_per_host`` to the devices of a sequence over the
    hosts. ``devices`` as ``make_ckks_mesh``'s: one device serves any
    count."""
    if hosts is None:
        dist = torch.distributed
        hosts = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
    single = devices is None or isinstance(devices, (str, torch.device))
    if chips_per_host is None:
        if single:
            raise ValueError("chips_per_host is needed with one device")
        chips_per_host = len(devices) // hosts
    total = hosts * chips_per_host
    if not single and total > len(devices):
        raise ValueError(f"need {total} devices for {hosts} hosts x "
                         f"{chips_per_host}, have {len(devices)}")
    if batch_per_host < 1 or chips_per_host % batch_per_host:
        raise ValueError("batch_per_host must divide chips_per_host")
    return Mesh(("host", "batch", "channel"),
                (hosts, batch_per_host, chips_per_host // batch_per_host),
                _grid_devices(devices, total))


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Which mesh axes split each array axis: per axis None (replicated), an
    axis name, or a tuple of names (split over their product, the first
    outermost). Specs of one mesh and one layout compare equal."""

    mesh: Mesh
    axes: tuple

    def names(self, dim: int) -> tuple:
        a = self.axes[dim]
        return () if a is None else (a,) if isinstance(a, str) else tuple(a)

    def parts(self, dim: int) -> int:
        return math.prod(self.mesh.shape[n] for n in self.names(dim))

    def block(self, shape: tuple, point: int) -> tuple:
        """The slices of a whole array of ``shape`` that ``point`` holds;
        raises ``ValueError`` where a mesh axis does not divide its array
        axis."""
        if len(shape) != len(self.axes):
            raise ValueError(f"a spec of {len(self.axes)} axes for shape {shape}")
        coords = self.mesh.coords(point)
        out = []
        for dim, size in enumerate(shape):
            names, parts = self.names(dim), self.parts(dim)
            if size % parts:
                raise ValueError(f"axis {dim} of size {size} does not split over "
                                 f"{names} ({parts} parts)")
            idx = 0
            for n in names:
                idx = idx * self.mesh.shape[n] + int(coords[n])
            step = size // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def replicas(self, point: int) -> bool:
        """Whether ``point`` holds a copy another point holds first (its
        index is not 0 along a mesh axis that the spec does not use)."""
        used = {n for dim in range(len(self.axes)) for n in self.names(dim)}
        coords = self.mesh.coords(point)
        return any(coords[n] for n in self.mesh.axis_names if n not in used)


def _spec(mesh: Mesh, *axes) -> ShardSpec:
    return ShardSpec(mesh, tuple(axes))


def ct_spec_mh(mesh: Mesh, batched: bool = True) -> ShardSpec:
    """Ciphertext planes on a (host, batch, channel) mesh: the batch over
    host x batch, channels over the channel axis."""
    if batched:
        return _spec(mesh, ("host", "batch"), "channel", None)
    return _spec(mesh, "channel", None)


def key_spec_mh(mesh: Mesh) -> ShardSpec:
    """Gadget keys on a (host, batch, channel) mesh: digits over the
    channel axis, replicated across hosts (the digit sum stays within a
    host)."""
    return _spec(mesh, "channel", None, None)


def ct_spec(mesh: Mesh, batched: bool = True) -> ShardSpec:
    """Ciphertext planes (B, L, N) / (L, N): the batch over ``batch``, the
    channels over ``channel``."""
    if batched:
        return _spec(mesh, "batch", "channel", None)
    return _spec(mesh, "channel", None)


def key_spec(mesh: Mesh) -> ShardSpec:
    """Gadget key stacks (D, E, N): the digits over ``channel``, so each
    point forms its digits' products and the digit sum is a sum over the
    axis; the raised channel axis stays whole."""
    return _spec(mesh, "channel", None, None)


def replicated(mesh: Mesh, ndim: int = 3) -> ShardSpec:
    """Every point holds the whole array (the reference's ``P()``)."""
    return _spec(mesh, *([None] * ndim))


def ct_spec_for(mesh: Mesh, num_channels: int, batched: bool = True) -> ShardSpec:
    """``ct_spec`` where the channel count splits over the channel axis,
    else the channels replicated along it (e.g. the L - 1 channels after
    a rescale on an L-wide axis)."""
    if num_channels % mesh.shape["channel"] == 0:
        return ct_spec(mesh, batched)
    if batched:
        return _spec(mesh, "batch", None, None)
    return _spec(mesh, None, None)


def key_spec_for(mesh: Mesh, num_digits: int) -> ShardSpec:
    """``key_spec`` where the digit count splits over the channel axis, else
    the key replicated (e.g. a digit_size > 1 key with D below the axis)."""
    if num_digits % mesh.shape["channel"] == 0:
        return key_spec(mesh)
    return _spec(mesh, None, None, None)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A whole array of ``shape`` laid out by ``spec``: ``blocks[i]`` the
    block grid point i holds, on its device."""

    spec: ShardSpec
    shape: tuple
    blocks: tuple


def shard(x: torch.Tensor, spec: ShardSpec) -> Sharded:
    """``x`` laid out by ``spec``: each point's block copied to its device
    (a block on the device ``x`` lies on is a view of ``x`` where it is
    contiguous there)."""
    shape = tuple(x.shape)
    blocks = tuple(x[spec.block(shape, p)].to(dev).contiguous()
                   for p, dev in enumerate(spec.mesh.points))
    return Sharded(spec, shape, blocks)


def unshard(value: Sharded) -> torch.Tensor:
    """The whole array of a sharded value, on its first point's device."""
    first = value.blocks[0]
    out = torch.empty(value.shape, dtype=first.dtype, device=first.device)
    for p, block in enumerate(value.blocks):
        if not value.spec.replicas(p):
            out[value.spec.block(value.shape, p)] = block.to(first.device)
    return out


# ── the coefficient mesh ─────────────────────────────────────────────────


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
    if not (device is None or isinstance(device, (str, torch.device))):
        if len(tuple(device)) != shards:
            raise ValueError(f"{len(tuple(device))} devices for {shards} shards")
    return CoeffMesh(_grid_devices(device, shards))


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
