"""The port's device mesh and the arrays dealt over it.

:class:`Mesh` is the port's ``jax.sharding.Mesh``: devices with named
axes, where a device may repeat (logical shards that share a card, or
the CPU). A partition spec is a tuple with one entry a dimension:
``None``, an axis name, or a tuple of axis names, e.g. ``("data", None)``
or ``(("pod", "data"), None)``; the named dimension is split into
contiguous equal chunks, numbered over the named axes in the order given
(the first axis major), as ``shard_map`` reads ``in_specs``.
:func:`shard_array` deals an array so, each device's shards stacked
``[S, m_local, ...]`` so that one batched op serves them all.

The sharded strategies (:mod:`repro_torch.core.sharded`) and the sharded
norm layout (:mod:`repro_torch.core.layout`) build on this module.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _device(d) -> torch.device:
    """A device with its index (``cuda`` -> ``cuda:<current>``), so the
    shards of one card group together."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices with named axes, the port's ``jax.sharding.Mesh``.

    ``devices`` is an ``np.ndarray`` of ``torch.device`` with one
    dimension per name of ``axis_names``; a device may repeat (logical
    shards that share a card, or the CPU).
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d devices for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = devs
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``devices`` (row-major), by
    default every visible CUDA device. ``devices`` may repeat a device:
    ``make_mesh((4,), ("data",), ["cuda:0"] * 4)`` is four logical shards
    on one card, ``["cpu"] * 4`` four on the CPU."""
    shape = tuple(int(s) for s in shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n "
                "for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    if len(devs) != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} devices, "
                         f"got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def spec_split(spec) -> Tuple[int, Tuple[str, ...]]:
    """``(dimension, axes)`` of a partition spec that splits one
    dimension."""
    split = [(d, e) for d, e in enumerate(spec) if e is not None]
    if len(split) != 1:
        raise ValueError(f"partition spec {spec!r} must split exactly one "
                         "dimension")
    d, e = split[0]
    return d, ((e,) if isinstance(e, str) else tuple(e))


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The shards (in increasing order) that live on one device."""

    device: torch.device
    shards: Tuple[int, ...]


def axis_sizes(mesh: Mesh, axes: Sequence[str]) -> List[int]:
    unknown = [a for a in axes if a not in mesh.axis_names]
    if unknown:
        raise ValueError(f"axes {unknown} are not in the mesh's "
                         f"{mesh.axis_names}")
    return [mesh.shape[a] for a in axes]


def shard_groups(mesh: Mesh, axes: Sequence[str]) -> Tuple[ShardGroup, ...]:
    """The shards of a split over ``axes`` (numbered first axis major)
    grouped by device, devices in the order of their first shard. Shard
    ``i`` runs on the device at its coordinates on ``axes`` and 0 on
    every other axis (the other axes replicate it)."""
    sizes = axis_sizes(mesh, axes)
    where = [mesh.axis_names.index(a) for a in axes]
    by_dev: Dict[torch.device, List[int]] = {}
    for i in range(math.prod(sizes)):
        coords = [0] * mesh.devices.ndim
        for pos, c in zip(where, np.unravel_index(i, sizes)):
            coords[pos] = int(c)
        by_dev.setdefault(mesh.devices[tuple(coords)], []).append(i)
    return tuple(ShardGroup(d, tuple(s)) for d, s in by_dev.items())


def gather_order(mesh: Mesh, axes: Sequence[str]) -> List[int]:
    """The shard order of a tiled ``all_gather`` over each of ``axes`` in
    turn: the last gathered axis is the outermost."""
    sizes = axis_sizes(mesh, axes)
    return [int(np.ravel_multi_index(rc[::-1], sizes))
            for rc in itertools.product(*(range(s) for s in sizes[::-1]))]


def take_shards(x: torch.Tensor, shards: Sequence[int], dim: int = 0):
    """The ``shards`` of ``x`` along ``dim`` (one index each), a view. They
    must be a contiguous increasing run, as a device's shards are on a
    mesh whose device list repeats each device in one block; raises
    ``ValueError`` otherwise."""
    lo = shards[0]
    if list(shards) != list(range(lo, lo + len(shards))):
        raise ValueError(f"shards {list(shards)} of one device are not a "
                         f"contiguous run")
    return x.narrow(dim, lo, len(shards))


@dataclasses.dataclass(frozen=True)
class ShardedArray:
    """An array dealt over a mesh: one ``[S_g, *shard_shape]`` stack of
    shards a device (``parts`` aligned with ``groups``). ``np.asarray``
    and :meth:`gather` give the whole array back."""

    mesh: Mesh
    spec: tuple
    groups: Tuple[ShardGroup, ...]
    parts: Tuple[torch.Tensor, ...]

    @property
    def n_shards(self) -> int:
        return sum(len(g.shards) for g in self.groups)

    @property
    def dim(self) -> int:
        return spec_split(self.spec)[0]

    @property
    def shape(self) -> Tuple[int, ...]:
        shp = list(self.parts[0].shape[1:])
        shp[self.dim] *= self.n_shards
        return tuple(shp)

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default: the first shard's)."""
        dev = self.groups[0].device if device is None else device
        pieces: List[Optional[torch.Tensor]] = [None] * self.n_shards
        for g, part in zip(self.groups, self.parts):
            for j, s in enumerate(g.shards):
                pieces[s] = part[j].to(dev)
        return torch.cat(pieces, dim=self.dim)

    def __array__(self, dtype=None, copy=None):
        out = self.gather(torch.device("cpu")).numpy()
        return out if dtype is None else out.astype(dtype)


def shard_array(x, mesh: Mesh, spec) -> ShardedArray:
    """Deal ``x`` over ``mesh`` by the partition ``spec`` (the port's
    counterpart of ``shard_map``'s ``in_specs``): the split dimension
    into equal contiguous chunks, each device's shards stacked on a new
    leading axis and moved there. A stack of consecutive shards of a
    contiguous tensor already on its device is a view (no copy). An
    array already dealt by the same mesh and spec is returned as is."""
    if isinstance(x, ShardedArray):
        if x.mesh is mesh and spec_split(x.spec) == spec_split(spec):
            return x
        x = x.gather()
    x = torch.as_tensor(x)
    dim, axes = spec_split(spec)
    groups = shard_groups(mesh, axes)
    n = sum(len(g.shards) for g in groups)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split into {n} equal shards")
    stacked = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    parts = []
    for g in groups:
        lo = g.shards[0]
        piece = (stacked[lo:lo + len(g.shards)]
                 if g.shards == tuple(range(lo, lo + len(g.shards)))
                 else stacked[list(g.shards)])
        parts.append(piece.to(g.device).contiguous())
    return ShardedArray(mesh, tuple(spec), groups, tuple(parts))
