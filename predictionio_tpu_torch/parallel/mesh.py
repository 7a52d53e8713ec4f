"""The in-process device mesh (port of the JAX package's
``parallel/mesh.py``).

A JAX mesh is a single-controller grid of devices with named axes;
``shard_map`` runs one local program per grid position and joins them
with collectives. The port mirrors that in one process:

- :class:`Mesh` is a grid of ``torch.device``s with axis names, such as
  ``("data", "model")``; ``shape`` is a dict, as in JAX. A device may
  stand at several positions (``["cpu"] * 8`` in the tests,
  ``["cuda:0"] * 4`` on one card), the counterpart of JAX's forced host
  device count.
- :class:`ShardedArray` is one local tensor per mesh position, on that
  position's device, and a spec with one entry per dimension: ``None``
  or the axis name that dimension is split over (a ``PartitionSpec``).
  Every entry ``None`` is a replicated array.
- :func:`all_gather`, :func:`psum` and :func:`axis_index` are the
  collectives: moves to the target device (``Tensor.to``) and a
  ``torch.cat`` or a sum, one code path for distinct cards, a repeated
  card and the CPU. Positions that share a device and would receive the
  same result share one tensor.

A sharded function is a loop over ``mesh.positions`` for its local phase
(each position touching only its own shard, on its own device), then a
collective, then the next local phase.

Conventions (workflow/context.EngineContext): batch-like dimensions
shard over ``data``, embedding-table rows over ``model``. Ragged host
data is padded to a multiple of the axis size before it is split.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterable, Sequence

import numpy as np
import torch

Position = tuple[int, ...]


class Mesh:
    """A grid of devices with named axes (``devices`` is array-like of
    device names or ``torch.device``s; its shape is the mesh's)."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if grid.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {grid.shape} needs {grid.ndim} distinct axis "
                             f"names, got {names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            self.devices[pos] = torch.device(grid[pos])
        self.axis_names = names

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (JAX's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    @property
    def positions(self) -> list[Position]:
        """Every grid position, row-major: the order of a
        :class:`ShardedArray`'s shards."""
        return list(np.ndindex(self.devices.shape))

    def device(self, pos: Position) -> torch.device:
        return self.devices[pos]

    def flat(self, pos: Position) -> int:
        return int(np.ravel_multi_index(pos, self.devices.shape))

    def group(self, pos: Position, axes: Iterable[str]) -> list[Position]:
        """The positions that differ from ``pos`` only along ``axes``,
        row-major (the members of a collective over those axes)."""
        axes = set(axes)
        return list(itertools.product(*(range(n) if name in axes else (pos[i],)
                                         for i, (name, n) in enumerate(self.shape.items()))))

    def __repr__(self) -> str:
        devs = list(dict.fromkeys(self.devices.reshape(-1)))
        return (f"Mesh({self.shape}, {self.size} positions on {len(devs)} device(s): "
                f"{', '.join(map(str, devs))})")


def axis_index(mesh: Mesh, pos: Position, axis: str) -> int:
    """The index of ``pos`` along ``axis`` (0 for an axis the mesh does
    not have; JAX's ``lax.axis_index``)."""
    if axis not in mesh.axis_names:
        return 0
    return int(pos[mesh.axis_names.index(axis)])


def _spec(spec: Sequence[str | None], ndim: int) -> tuple[str | None, ...]:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} has more entries than the array's {ndim} dims")
    return spec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where :func:`device_put` places an array."""

    mesh: Mesh
    spec: tuple[str | None, ...] = ()


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def data_sharding(mesh: Mesh, ndim: int = 1, axis: int = 0) -> NamedSharding:
    """Dimension ``axis`` split over the "data" mesh axis."""
    spec = [None] * ndim
    spec[axis] = "data"
    return NamedSharding(mesh, tuple(spec))


def model_sharding(mesh: Mesh, ndim: int = 2, axis: int = 0) -> NamedSharding:
    """Dimension ``axis`` split over the "model" mesh axis (embedding rows)."""
    spec = [None] * ndim
    spec[axis] = "model"
    return NamedSharding(mesh, tuple(spec))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedArray:
    """One local tensor per mesh position (``shards``, row-major over
    ``mesh.positions``), each on its position's device, laid out by
    ``spec``. Along a split dimension the shards may be uneven (a table
    trimmed after padding); positions that differ only along axes the
    spec does not name hold the same values."""

    mesh: Mesh
    spec: tuple[str | None, ...]
    shards: tuple[torch.Tensor, ...]

    def __post_init__(self):
        if len(self.shards) != self.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of {self.mesh.size}")
        object.__setattr__(self, "spec", _spec(self.spec, self.shards[0].ndim))

    @staticmethod
    def from_local(mesh: Mesh, spec: Sequence[str | None], fn) -> "ShardedArray":
        """A sharded array whose shard at each position is ``fn(pos)``."""
        return ShardedArray(mesh, tuple(spec), tuple(fn(pos) for pos in mesh.positions))

    def local(self, pos: Position) -> torch.Tensor:
        return self.shards[self.mesh.flat(pos)]

    @property
    def ndim(self) -> int:
        return self.shards[0].ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The first position's device, where gathered results land."""
        return self.shards[0].device

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def ways(self, axis: str = "model") -> int:
        """How many ways the array is split over ``axis`` (1 when no
        dimension is)."""
        return self.mesh.axis_size(axis) if axis in self.spec else 1

    def _origin(self) -> Position:
        return (0,) * len(self.mesh.axis_names)

    def _sizes(self, dim: int) -> list[int]:
        """The shards' sizes along ``dim``, in axis order."""
        axis = self.spec[dim]
        if axis is None:
            return [self.shards[0].shape[dim]]
        return [self.local(p).shape[dim] for p in self.mesh.group(self._origin(), (axis,))]

    @property
    def shape(self) -> torch.Size:
        return torch.Size(sum(self._sizes(d)) for d in range(self.ndim))

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole array on ``device`` (default: the first position's)."""
        dev = self.device if device is None else torch.device(device)
        split = [a for a in self.spec if a is not None]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        offsets = [np.concatenate([[0], np.cumsum(self._sizes(d))]) for d in range(self.ndim)]
        for pos in self.mesh.group(self._origin(), split):
            region = tuple(
                slice(None) if a is None else
                slice(int(offsets[d][axis_index(self.mesh, pos, a)]),
                      int(offsets[d][axis_index(self.mesh, pos, a) + 1]))
                for d, a in enumerate(self.spec))
            out[region] = self.local(pos).to(dev)
        return out

    def rows(self, index) -> torch.Tensor:
        """Rows ``index`` (an int, a slice or an index array) of the
        array on the first position's device: each shard along dim 0
        gives the rows it owns (an ``index_select`` on its device), so no
        whole table moves."""
        n = self.shape[0]
        if isinstance(index, slice):
            index = torch.arange(n)[index]
        scalar = isinstance(index, (int, np.integer))
        idx = torch.as_tensor(np.asarray(index) if not isinstance(index, torch.Tensor)
                              else index).long().reshape(-1).to(self.device)
        axis = self.spec[0]
        if axis is None:
            out = self.shards[0].index_select(0, idx)
        else:
            bounds = np.concatenate([[0], np.cumsum(self._sizes(0))])
            out = torch.zeros((idx.shape[0], *self.shards[0].shape[1:]), dtype=self.dtype,
                              device=self.device)
            for j, pos in enumerate(self.mesh.group(self._origin(), (axis,))):
                lo, hi = int(bounds[j]), int(bounds[j + 1])
                if hi == lo:
                    continue
                shard = self.local(pos)
                owned = (idx >= lo) & (idx < hi)
                local = (idx - lo).clamp(0, hi - lo - 1).to(shard.device)
                got = shard.index_select(0, local).to(self.device)
                out = torch.where(owned.view(-1, *([1] * (out.ndim - 1))), got, out)
        return out[0] if scalar else out

    def __getitem__(self, index) -> torch.Tensor:
        return self.rows(index)

    def head(self, n: int) -> "ShardedArray":
        """The first ``n`` rows, split as they are: each shard along dim 0
        keeps the rows it holds below ``n`` (the last may come out
        shorter, or empty)."""
        if self.spec[0] is None:
            return ShardedArray(self.mesh, self.spec, per_device(
                self.mesh, lambda pos: self.local(pos)[:n], lambda pos: id(self.local(pos))))
        bounds = np.concatenate([[0], np.cumsum(self._sizes(0))])

        def cut(pos):
            lo = int(bounds[axis_index(self.mesh, pos, self.spec[0])])
            return self.local(pos)[: max(0, min(self.local(pos).shape[0], n - lo))]

        return ShardedArray(self.mesh, self.spec, per_device(
            self.mesh, cut, lambda pos: id(self.local(pos))))

    def cpu(self) -> torch.Tensor:
        return self.gather("cpu")

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedArray(shape={tuple(self.shape)}, dtype={self.dtype}, spec={self.spec}, "
                f"mesh={self.mesh.shape})")


def per_device(mesh: Mesh, make, key) -> tuple[torch.Tensor, ...]:
    """``make(pos)`` for each position, made once per (device, ``key(pos)``):
    positions on one device that would receive the same values share
    one tensor."""
    made: dict = {}
    out = []
    for pos in mesh.positions:
        k = (mesh.device(pos), key(pos))
        if k not in made:
            made[k] = make(pos)
        out.append(made[k])
    return tuple(out)


def device_put(x, sharding: NamedSharding) -> ShardedArray:
    """A tensor or host array placed on ``sharding``'s mesh: each
    position gets its slice on its device. A split dimension must divide
    its axis, as in JAX."""
    mesh = sharding.mesh
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    spec = _spec(sharding.spec, t.ndim)
    for d, a in enumerate(spec):
        if a is not None and t.shape[d] % mesh.axis_size(a):
            raise ValueError(f"dimension {d} ({t.shape[d]}) does not divide the {a!r} mesh "
                             f"axis ({mesh.axis_size(a)})")

    def region(pos):
        return tuple(
            slice(None) if a is None else
            slice(axis_index(mesh, pos, a) * (t.shape[d] // mesh.axis_size(a)),
                  (axis_index(mesh, pos, a) + 1) * (t.shape[d] // mesh.axis_size(a)))
            for d, a in enumerate(spec))

    def key(pos):
        return tuple((r.start, r.stop) for r in region(pos))

    return ShardedArray(mesh, spec, per_device(
        mesh, lambda pos: t[region(pos)].to(mesh.device(pos)).contiguous(), key))


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0,
                    fill: Any = 0) -> tuple[np.ndarray, int]:
    """``array`` padded along ``axis`` to the next multiple (an empty one
    to one multiple): (padded, original length)."""
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple if n else multiple
    if target == n:
        return array, n
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(array, pad_width, constant_values=fill), n


def shard_put(array, mesh: Mesh, axis: int = 0, mesh_axis: str = "data") -> ShardedArray:
    """A host array split along ``axis`` over one mesh axis."""
    spec = [None] * np.ndim(array)
    spec[axis] = mesh_axis
    return device_put(array, NamedSharding(mesh, tuple(spec)))


def shard_batch(arrays: Sequence[np.ndarray], mesh: Mesh,
                fill: Any = 0) -> tuple[list[ShardedArray], int]:
    """Equal-length host arrays padded with ``fill`` to the data-axis
    multiple and split over it: (sharded arrays, original length)."""
    n = arrays[0].shape[0]
    return [shard_put(pad_to_multiple(np.asarray(a), mesh.axis_size("data"), fill=fill)[0],
                      mesh) for a in arrays], n


def local_map(mesh: Mesh, fn, *arrays: ShardedArray, spec: Sequence[str | None] = ()):
    """The local phase of a sharded function: ``fn`` of each position's
    local tensors of ``arrays``, as a :class:`ShardedArray` laid out by
    ``spec`` (a tuple of them when ``fn`` returns a tuple). Positions
    whose local tensors are the very same objects (a device repeated
    along an axis the inputs are not split over) compute once."""
    made = per_device(mesh, lambda pos: fn(*(a.local(pos) for a in arrays)),
                      lambda pos: tuple(id(a.local(pos)) for a in arrays))
    if isinstance(made[0], tuple):
        return tuple(ShardedArray(mesh, tuple(spec), tuple(m[i] for m in made))
                     for i in range(len(made[0])))
    return ShardedArray(mesh, tuple(spec), made)


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def all_gather(x: ShardedArray, axis: str, dim: int | None = None) -> ShardedArray:
    """The tiled all-gather over ``axis``: each position gets the shards
    of its group along ``axis`` concatenated along ``dim`` (default: the
    dimension the spec splits over ``axis``), on its device."""
    mesh = x.mesh
    if dim is None:
        if axis not in x.spec:
            raise ValueError(f"no dimension of spec {x.spec} is split over {axis!r}")
        dim = x.spec.index(axis)
    spec = tuple(None if a == axis else a for a in x.spec)

    def gathered(pos):
        dev = mesh.device(pos)
        return torch.cat([x.local(p).to(dev) for p in mesh.group(pos, (axis,))], dim=dim)

    def key(pos):
        return tuple(p for i, p in enumerate(pos) if mesh.axis_names[i] != axis)

    return ShardedArray(mesh, spec, per_device(mesh, gathered, key))


def psum(x: ShardedArray, axis: str | Sequence[str]) -> ShardedArray:
    """The sum over ``axis`` (a name or several) of the positions'
    values, at every position of each group, on its device."""
    mesh = x.mesh
    axes = _axes(axis)

    def summed(pos):
        dev = mesh.device(pos)
        group = mesh.group(pos, axes)
        out = x.local(group[0]).to(dev, copy=True)
        for p in group[1:]:
            out += x.local(p).to(dev)
        return out

    def key(pos):
        return tuple(p for i, p in enumerate(pos) if mesh.axis_names[i] not in axes)

    return ShardedArray(mesh, x.spec, per_device(mesh, summed, key))

