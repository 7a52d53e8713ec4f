"""The device mesh (port of the JAX package's ``parallel/mesh.py``), in
one process or across the processes of a ``torch.distributed`` group.

A JAX mesh is a grid of devices with named axes; ``shard_map`` runs one
local program per grid position and joins them with collectives. The
port mirrors that:

- :class:`Mesh` is a grid of ``torch.device``s with axis names, such as
  ``("data", "model")`` or ``("data", "seq")``; ``shape`` is a dict, as
  in JAX. A device may stand at several positions (``["cpu"] * 8`` in
  the tests, ``["cuda:0"] * 4`` on one card), the counterpart of JAX's
  forced host device count. Every position has an owning rank
  (``ranks``; by default this process owns them all). A mesh whose
  positions have several owners is global, as a JAX mesh over
  ``jax.devices()`` under ``jax.distributed`` is: every rank builds the
  same mesh, in the same order, and each drives only its
  ``local_positions``.
- :class:`ShardedArray` is one local tensor per local position, on that
  position's device, and a spec with one entry per dimension: ``None``
  or the axis name that dimension is split over (a ``PartitionSpec``).
  Every entry ``None`` is a replicated array.
- :func:`all_gather`, :func:`psum`, :func:`ppermute` and
  :func:`axis_index` are the collectives. Within a process they are
  moves to the target device (``Tensor.to``) and a ``torch.cat`` or a
  sum, one code path for distinct cards, a repeated card and the CPU;
  positions that share a device and would receive the same values share
  one tensor. Between processes they run over ``torch.distributed``
  groups made once, when the mesh is built. A gather or a ppermute moves
  each position's value as it is, so it equals the in-process one. Every
  sum across processes takes one route (:func:`_all_reduce`): each rank
  adds its own positions in the group's order, then one all-reduce adds
  the ranks' partial sums. That equals the in-process sum up to the
  order of its additions, bit for bit where the group spans two ranks
  that hold one position each. Over gloo a card's tensors go through
  host memory (``.cpu()`` in, ``.to(card)`` out); ``COMM`` counts the
  collectives, their seconds and those bytes.

A sharded function is a loop over ``mesh.local_positions`` for its local
phase (each position touching only its own shard, on its own device),
then a collective, then the next local phase. ``mesh.home`` (the first
local position) holds results that every position shares.

Conventions (workflow/context.EngineContext): batch-like dimensions
shard over ``data``, embedding-table rows over ``model``, sequence
positions over ``seq``. Ragged host data is padded to a multiple of the
axis size before it is split.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Any, Iterable, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

Position = tuple[int, ...]

#: cross-process collectives: calls, seconds in them, and the bytes of
#: card tensors staged through host memory for a gloo transfer
COMM = {"calls": 0, "seconds": 0.0, "host_bytes": 0}

#: process groups by their (sorted) ranks, made once for every mesh
_PROCESS_GROUPS: dict[tuple[int, ...], Any] = {}


def _dist():
    import torch.distributed as dist

    return dist


def _this_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A grid of devices with named axes (``devices`` is array-like of
    device names or ``torch.device``s; its shape is the mesh's).
    ``ranks`` (same shape) names each position's owning process; without
    it this process owns every position. A mesh with several owners needs
    an initialized process group, and every rank must build it (it makes
    the groups of its collectives)."""

    def __init__(self, devices: Any, axis_names: Sequence[str], ranks: Any = None):
        grid = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if grid.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {grid.shape} needs {grid.ndim} distinct axis "
                             f"names, got {names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            dev = torch.device(grid[pos])
            # "cuda" is the first card, where a tensor sent to it lands
            self.devices[pos] = torch.device("cuda", 0) if dev == torch.device("cuda") else dev
        self.axis_names = names
        self.rank = _this_rank()
        self.ranks = (np.full(grid.shape, self.rank, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(grid.shape))
        self.local_positions: list[Position] = [p for p in self.positions
                                                if self.ranks[p] == self.rank]
        if not self.local_positions:
            raise ValueError(f"rank {self.rank} owns no position of the mesh")
        self._local_index = {p: i for i, p in enumerate(self.local_positions)}
        self.multiprocess = len(set(self.ranks.reshape(-1).tolist())) > 1
        if self.multiprocess:
            dist = _dist()
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError("a mesh over several ranks needs an initialized process "
                                   "group (parallel/distributed.maybe_initialize_distributed)")
            self._make_groups()

    def _make_groups(self) -> None:
        """One process group for each set of ranks that a collective over
        some of the axes joins; ``new_group`` runs on every rank, in the
        same order, so no rank waits on a group another never makes."""
        dist = _dist()
        world = dist.get_world_size()
        for r in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                for pos in self.positions:
                    ranks = self.group_ranks(self.group(pos, axes))
                    if len(ranks) > 1 and ranks not in _PROCESS_GROUPS:
                        _PROCESS_GROUPS[ranks] = (dist.group.WORLD if len(ranks) == world
                                                  else dist.new_group(list(ranks)))

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
        """Every grid position, row-major, this process's or not."""
        return list(np.ndindex(self.devices.shape))

    @property
    def home(self) -> Position:
        """The first local position: where a result that every position
        shares is kept."""
        return self.local_positions[0]

    def device(self, pos: Position) -> torch.device:
        return self.devices[pos]

    def owner(self, pos: Position) -> int:
        return int(self.ranks[pos])

    def is_local(self, pos: Position) -> bool:
        return pos in self._local_index

    def local_index(self, pos: Position) -> int:
        return self._local_index[pos]

    def flat(self, pos: Position) -> int:
        return int(np.ravel_multi_index(pos, self.devices.shape))

    def group(self, pos: Position, axes: Iterable[str]) -> list[Position]:
        """The positions that differ from ``pos`` only along ``axes``,
        row-major (the members of a collective over those axes)."""
        axes = set(axes)
        return list(itertools.product(*(range(n) if name in axes else (pos[i],)
                                         for i, (name, n) in enumerate(self.shape.items()))))

    def group_ranks(self, group: Sequence[Position]) -> tuple[int, ...]:
        return tuple(sorted({self.owner(p) for p in group}))

    def process_group(self, ranks: tuple[int, ...]):
        return _PROCESS_GROUPS[ranks]

    def section(self, axes: Iterable[str]) -> "Mesh | None":
        """The mesh over ``axes`` alone, at index 0 along every other
        axis: where a function that does not use those other axes runs
        once. ``None`` where this rank owns none of its positions. Each of
        its groups is a group of this mesh, so building it makes no new
        process group."""
        axes = set(axes)
        keep = tuple(a for a in self.axis_names if a in axes)
        at = tuple(slice(None) if a in axes else 0 for a in self.axis_names)
        ranks = np.asarray(self.ranks[at])
        if not (ranks == self.rank).any():
            return None
        return Mesh(np.asarray(self.devices[at], dtype=object), keep, ranks=ranks)

    def __repr__(self) -> str:
        devs = list(dict.fromkeys(self.devices.reshape(-1)))
        procs = len(set(self.ranks.reshape(-1).tolist()))
        return (f"Mesh({self.shape}, {self.size} positions on {len(devs)} device(s): "
                f"{', '.join(map(str, devs))}" + (f"; {procs} processes" if procs > 1 else "")
                + ")")


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
    """One local tensor per local position (``shards``, in the order of
    ``mesh.local_positions``), each on its position's device, laid out by
    ``spec``. Along a split dimension the shards may be uneven (a table
    trimmed after padding) where the axis stays within this process;
    across processes they are even. Positions that differ only along
    axes the spec does not name hold the same values."""

    mesh: Mesh
    spec: tuple[str | None, ...]
    shards: tuple[torch.Tensor, ...]

    def __post_init__(self):
        if len(self.shards) != len(self.mesh.local_positions):
            raise ValueError(f"{len(self.shards)} shards for {len(self.mesh.local_positions)} "
                             f"local positions")
        object.__setattr__(self, "spec", _spec(self.spec, self.shards[0].ndim))

    @staticmethod
    def from_local(mesh: Mesh, spec: Sequence[str | None], fn) -> "ShardedArray":
        """A sharded array whose shard at each local position is ``fn(pos)``."""
        return ShardedArray(mesh, tuple(spec), tuple(fn(pos) for pos in mesh.local_positions))

    def local(self, pos: Position) -> torch.Tensor:
        return self.shards[self.mesh.local_index(pos)]

    @property
    def ndim(self) -> int:
        return self.shards[0].ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The home position's device, where gathered results land."""
        return self.shards[0].device

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def ways(self, axis: str = "model") -> int:
        """How many ways the array is split over ``axis`` (1 when no
        dimension is)."""
        return self.mesh.axis_size(axis) if axis in self.spec else 1

    def _split_group(self, origin: Position | None = None) -> list[Position]:
        """The positions whose shards tile the whole array, from the home
        position (or ``origin``) along every split axis."""
        return self.mesh.group(origin or self.mesh.home, [a for a in self.spec if a is not None])

    def _sizes(self, dim: int) -> list[int]:
        """The shards' sizes along ``dim``, in axis order (even across
        processes)."""
        axis = self.spec[dim]
        home = self.mesh.home
        if axis is None:
            return [self.local(home).shape[dim]]
        group = self.mesh.group(home, (axis,))
        if all(self.mesh.is_local(p) for p in group):
            return [self.local(p).shape[dim] for p in group]
        return [self.local(home).shape[dim]] * len(group)

    @property
    def shape(self) -> torch.Size:
        return torch.Size(sum(self._sizes(d)) for d in range(self.ndim))

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole array on ``device`` (default: the home position's),
        JAX's ``jit(lambda x: x, out_shardings=replicated)``. When its
        shards lie on other processes this is a collective: every rank of
        the mesh calls it."""
        dev = self.device if device is None else torch.device(device)
        group = self._split_group()
        if all(self.mesh.is_local(p) for p in group):
            values = {p: self.local(p) for p in group}
        else:
            group = self._split_group((0,) * len(self.mesh.axis_names))
            values = _share(self.mesh, group, {p: self.local(p) for p in group
                                               if self.mesh.is_local(p)})
        sizes = [[values[p].shape[d] for p in self.mesh.group(group[0], (a,))] if a else
                 [values[group[0]].shape[d]] for d, a in enumerate(self.spec)]
        offsets = [np.concatenate([[0], np.cumsum(s)]) for s in sizes]
        out = torch.empty([int(o[-1]) for o in offsets], dtype=self.dtype, device=dev)
        for pos in group:
            region = tuple(
                slice(None) if a is None else
                slice(int(offsets[d][axis_index(self.mesh, pos, a)]),
                      int(offsets[d][axis_index(self.mesh, pos, a) + 1]))
                for d, a in enumerate(self.spec))
            out[region] = values[pos].to(dev)
        return out

    def rows(self, index) -> torch.Tensor:
        """Rows ``index`` (an int, a slice or an index array) of the
        array on the home position's device: each shard along dim 0
        gives the rows it owns (an ``index_select`` on its device), so no
        whole table moves. Over shards on other processes this gathers
        the array (a collective)."""
        n = self.shape[0]
        if isinstance(index, slice):
            index = torch.arange(n)[index]
        scalar = isinstance(index, (int, np.integer))
        idx = torch.as_tensor(np.asarray(index) if not isinstance(index, torch.Tensor)
                              else index).long().reshape(-1).to(self.device)
        axis = self.spec[0]
        group = [] if axis is None else self.mesh.group(self.mesh.home, (axis,))
        if axis is None:
            out = self.shards[0].index_select(0, idx)
        elif not all(self.mesh.is_local(p) for p in group):
            out = self.gather().index_select(0, idx)
        else:
            bounds = np.concatenate([[0], np.cumsum(self._sizes(0))])
            out = torch.zeros((idx.shape[0], *self.shards[0].shape[1:]), dtype=self.dtype,
                              device=self.device)
            for j, pos in enumerate(group):
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
    """``make(pos)`` for each local position, made once per (device,
    ``key(pos)``): positions on one device that would receive the same
    values share one tensor."""
    made: dict = {}
    out = []
    for pos in mesh.local_positions:
        k = (mesh.device(pos), key(pos))
        if k not in made:
            made[k] = make(pos)
        out.append(made[k])
    return tuple(out)


def _region(mesh: Mesh, pos: Position, spec, shape) -> tuple[slice, ...]:
    """``pos``'s block of an array of global ``shape`` laid out by ``spec``."""
    return tuple(
        slice(None) if a is None else
        slice(axis_index(mesh, pos, a) * (shape[d] // mesh.axis_size(a)),
              (axis_index(mesh, pos, a) + 1) * (shape[d] // mesh.axis_size(a)))
        for d, a in enumerate(spec))


def _check_divides(mesh: Mesh, spec, shape) -> None:
    for d, a in enumerate(spec):
        if a is not None and shape[d] % mesh.axis_size(a):
            raise ValueError(f"dimension {d} ({shape[d]}) does not divide the {a!r} mesh "
                             f"axis ({mesh.axis_size(a)})")


def device_put(x, sharding: NamedSharding) -> ShardedArray:
    """A tensor or host array placed on ``sharding``'s mesh: each local
    position gets its slice on its device. A split dimension must divide
    its axis, as in JAX."""
    mesh = sharding.mesh
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    spec = _spec(sharding.spec, t.ndim)
    _check_divides(mesh, spec, t.shape)

    def key(pos):
        return tuple((r.start, r.stop) for r in _region(mesh, pos, spec, t.shape))

    return ShardedArray(mesh, spec, per_device(
        mesh, lambda pos: t[_region(mesh, pos, spec, t.shape)].to(mesh.device(pos)).contiguous(),
        key))


def device_put_local(sharding: NamedSharding, local, global_shape: Sequence[int]
                     ) -> ShardedArray:
    """JAX's ``make_array_from_process_local_data``: ``local`` is this
    process's part of an array of ``global_shape`` — along each split
    dimension, the blocks of its local positions, in order (the whole
    dimension where it is not split). Each local position gets its block
    on its device."""
    mesh = sharding.mesh
    t = local if isinstance(local, torch.Tensor) else torch.from_numpy(np.array(local))
    shape = tuple(int(n) for n in global_shape)
    spec = _spec(sharding.spec, len(shape))
    _check_divides(mesh, spec, shape)
    regions = {p: _region(mesh, p, spec, shape) for p in mesh.local_positions}
    start = [0 if a is None else min(r[d].start for r in regions.values())
             for d, a in enumerate(spec)]
    want = [shape[d] if a is None else max(r[d].stop for r in regions.values()) - start[d]
            for d, a in enumerate(spec)]
    if list(t.shape) != want:
        raise ValueError(f"this process's data has shape {tuple(t.shape)}; its positions "
                         f"hold {tuple(want)} of {shape}")

    def block(pos):
        region = tuple(slice(r.start - s, r.stop - s) if r.start is not None else r
                       for r, s in zip(regions[pos], start))
        return t[region].to(mesh.device(pos)).contiguous()

    return ShardedArray(mesh, spec, per_device(
        mesh, block, lambda pos: tuple((r.start, r.stop) for r in regions[pos])))


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


def local_map(mesh: Mesh, fn, *arrays: ShardedArray, spec: Sequence[str | None] = (),
              with_pos: bool = False):
    """The local phase of a sharded function: ``fn`` of each local
    position's tensors of ``arrays`` (``fn(pos, *tensors)`` with
    ``with_pos``, which may read ``pos`` only along axes the inputs are
    split over), as a :class:`ShardedArray` laid out by ``spec`` (a tuple
    of them when ``fn`` returns a tuple; an output of lower rank takes
    the spec's leading entries). Positions whose local tensors
    are the very same objects (a device repeated along an axis the inputs
    are not split over) compute once."""
    def run(pos):
        tensors = tuple(a.local(pos) for a in arrays)
        return fn(pos, *tensors) if with_pos else fn(*tensors)

    def wrap(shards):   # a lower-rank output keeps the spec's leading entries
        return ShardedArray(mesh, tuple(spec)[: shards[0].ndim], shards)

    made = per_device(mesh, run, lambda pos: tuple(id(a.local(pos)) for a in arrays))
    if isinstance(made[0], tuple):
        return tuple(wrap(tuple(m[i] for m in made)) for i in range(len(made[0])))
    return wrap(made)


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _key_without(mesh: Mesh, pos: Position, axes: Sequence[str]) -> Position:
    return tuple(p for i, p in enumerate(pos) if mesh.axis_names[i] not in axes)


# ---------------------------------------------------------------------------
# Between processes: the transport under the collectives
# ---------------------------------------------------------------------------

_WIRE_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int64,
                torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)
_HEADER = 10   # dtype, ndim, up to 8 dims


def _wire_device() -> torch.device:
    """Where a transfer's bytes live: the host for gloo, this rank's card
    for NCCL."""
    dist = _dist()
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes (uint8) on the wire device; a card's tensor bound for
    the host is counted in ``COMM["host_bytes"]``."""
    dev = _wire_device()
    flat = t.detach().contiguous().reshape(-1)
    if flat.device != dev:
        if dev.type == "cpu":
            COMM["host_bytes"] += flat.numel() * flat.element_size()
        flat = flat.to(dev)
    return flat.view(torch.uint8)


def _from_wire(buf: torch.Tensor, dtype: torch.dtype, shape, device: torch.device
               ) -> torch.Tensor:
    out = buf.view(dtype).reshape(shape)
    if out.device != device:
        if out.device.type == "cpu":
            COMM["host_bytes"] += buf.numel()
        out = out.to(device)
    return out


def _header(t: torch.Tensor) -> torch.Tensor:
    if t.ndim > _HEADER - 2:
        raise ValueError(f"a {t.ndim}-d tensor does not fit the transfer header")
    h = torch.zeros(_HEADER, dtype=torch.int64)
    h[0], h[1] = _WIRE_DTYPES.index(t.dtype), t.ndim
    h[2: 2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
    return h


class _Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()
        COMM["calls"] += 1

    def __exit__(self, *exc):
        COMM["seconds"] += time.perf_counter() - self.t0


def _share(mesh: Mesh, group: Sequence[Position], values: dict) -> dict:
    """Every position of ``group`` with its value, at each rank of the
    group: ``values`` holds this process's; each other position's comes
    from its owner by a broadcast in the group's order (its shape and
    dtype first). Received values land on the home device."""
    ranks = mesh.group_ranks(group)
    if ranks == (mesh.rank,):
        return dict(values)
    dist = _dist()
    pg = mesh.process_group(ranks)
    dev = _wire_device()
    out = {}
    with _Timed():
        for pos in group:
            src = mesh.owner(pos)
            mine = src == mesh.rank
            header = _header(values[pos]) if mine else torch.zeros(_HEADER, dtype=torch.int64)
            header = header.to(dev)
            dist.broadcast(header, src, group=pg)
            h = header.cpu().tolist()
            dtype, shape = _WIRE_DTYPES[h[0]], tuple(h[2: 2 + h[1]])
            if mine:
                dist.broadcast(_to_wire(values[pos]), src, group=pg)
                out[pos] = values[pos]
            else:
                n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
                buf = torch.empty(n, dtype=torch.uint8, device=dev)
                dist.broadcast(buf, src, group=pg)
                out[pos] = _from_wire(buf, dtype, shape, mesh.device(mesh.home))
    return out


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """What a cross-process sum adds in: f64 for f64, int64 for integers,
    f32 for every other float."""
    if dtype == torch.float64:
        return dtype
    return torch.float32 if dtype.is_floating_point else torch.int64


def _all_reduce(mesh: Mesh, ranks: tuple[int, ...], tensors: Sequence[torch.Tensor]
                ) -> list[torch.Tensor]:
    """The sum over ``ranks`` of each of ``tensors`` (this rank's parts),
    on their devices, in their dtypes: one all-reduce for each dtype of
    :func:`_sum_dtype`. The only route by which ranks add values."""
    dist = _dist()
    dev = _wire_device()
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(_sum_dtype(t.dtype), []).append(i)
    for dtype, idx in by_dtype.items():
        parts = []
        for i in idx:
            t = tensors[i].detach().reshape(-1).to(dtype)
            if t.device != dev:
                if dev.type == "cpu":
                    COMM["host_bytes"] += t.numel() * t.element_size()
                t = t.to(dev)
            parts.append(t)
        flat = torch.cat(parts)
        with _Timed():
            dist.all_reduce(flat, group=mesh.process_group(ranks))
        at = 0
        for i in idx:
            t = tensors[i]
            part = flat[at: at + t.numel()].reshape(t.shape)
            at += t.numel()
            if part.device != t.device:
                if part.device.type == "cpu":
                    COMM["host_bytes"] += part.numel() * part.element_size()
                part = part.to(t.device)
            out[i] = part.to(t.dtype)
    return out


def process_sum(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum over the mesh's processes of each of ``tensors`` (this
    rank's parts), on their devices; the tensors themselves in a mesh of
    one process."""
    if not mesh.multiprocess:
        return list(tensors)
    return _all_reduce(mesh, mesh.group_ranks(mesh.positions), tensors)


def _groups_over(mesh: Mesh, axes: Sequence[str]) -> list[list[Position]]:
    """The groups of a collective over ``axes`` that hold a local
    position, in a canonical order that every rank walks alike."""
    seen, out = set(), []
    for pos in mesh.positions:
        k = _key_without(mesh, pos, axes)
        if k in seen:
            continue
        seen.add(k)
        group = mesh.group(pos, axes)
        if any(mesh.is_local(p) for p in group):
            out.append(group)
    return out


def _group_values(x: ShardedArray, axes: Sequence[str]) -> dict:
    """key without ``axes`` -> {position: value} over each group of a
    collective along ``axes``, the other processes' values shared."""
    mesh = x.mesh
    out = {}
    for group in _groups_over(mesh, axes):
        local = {p: x.local(p) for p in group if mesh.is_local(p)}
        out[_key_without(mesh, group[0], axes)] = _share(mesh, group, local)
    return out


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
    shared = _group_values(x, (axis,)) if mesh.multiprocess else None

    def gathered(pos):
        dev = mesh.device(pos)
        group = mesh.group(pos, (axis,))
        values = (shared[_key_without(mesh, pos, (axis,))] if shared is not None
                  else {p: x.local(p) for p in group})
        return torch.cat([values[p].to(dev) for p in group], dim=dim)

    return ShardedArray(mesh, spec, per_device(
        mesh, gathered, lambda pos: _key_without(mesh, pos, (axis,))))


def _sum_over(x: ShardedArray, positions: Sequence[Position], dev: torch.device
              ) -> torch.Tensor:
    """The sum of ``x``'s local values at ``positions``, in their order,
    on ``dev``."""
    out = x.local(positions[0]).to(dev, copy=True)
    for p in positions[1:]:
        out += x.local(p).to(dev)
    return out


def _psum_values(x: ShardedArray, axes: tuple[str, ...], shards) -> tuple[torch.Tensor, ...]:
    mesh = x.mesh
    y = ShardedArray(mesh, x.spec, tuple(shards))
    across = {}   # the groups that span ranks: their sums, by key without ``axes``
    for group in _groups_over(mesh, axes) if mesh.multiprocess else ():
        ranks = mesh.group_ranks(group)
        if len(ranks) > 1:
            local = [p for p in group if mesh.is_local(p)]
            part = _sum_over(y, local, mesh.device(local[0]))
            across[_key_without(mesh, group[0], axes)] = _all_reduce(mesh, ranks, [part])[0]

    def summed(pos):
        key = _key_without(mesh, pos, axes)
        if key in across:
            return across[key].to(mesh.device(pos), copy=True)
        return _sum_over(y, mesh.group(pos, axes), mesh.device(pos))

    return per_device(mesh, summed, lambda pos: _key_without(mesh, pos, axes))


class _PSum(torch.autograd.Function):
    """``psum`` across processes; its adjoint is the psum of the
    incoming gradients (each rank's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, x: ShardedArray, axes: tuple[str, ...], *shards):
        ctx.x, ctx.axes = x, axes
        return tuple(t.clone() for t in _psum_values(x, axes, shards))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(s) if g is None else g for g, s in zip(grads, ctx.x.shards)]
        return (None, None, *_psum_values(ctx.x, ctx.axes, grads))


def psum(x: ShardedArray, axis: str | Sequence[str]) -> ShardedArray:
    """The sum over ``axis`` (a name or several) of the positions'
    values, at every position of each group, on its device: in the
    group's order within a process, through :func:`_all_reduce` across
    processes. Differentiable."""
    axes = _axes(axis)
    if x.mesh.multiprocess and any(len(x.mesh.group_ranks(g)) > 1
                                   for g in _groups_over(x.mesh, axes)):
        return ShardedArray(x.mesh, x.spec, _PSum.apply(x, axes, *x.shards))
    return ShardedArray(x.mesh, x.spec, _psum_values(x, axes, x.shards))


def _shifted(mesh: Mesh, pos: Position, axis: str, shift: int) -> Position:
    i = mesh.axis_names.index(axis)
    out = list(pos)
    out[i] = (pos[i] + shift) % mesh.axis_size(axis)
    return tuple(out)


def _value_key(mesh: Mesh, pos: Position, spec) -> Position:
    """``pos``'s coordinates along the axes ``spec`` names: positions
    with one key hold the same values."""
    return tuple(p for i, p in enumerate(pos) if mesh.axis_names[i] in spec)


def _receivers(mesh: Mesh, spec) -> list[Position]:
    """One position for each (owner, device, value key): those receive a
    ppermute's shard; the rest of their kind share it."""
    seen, out = set(), []
    for pos in mesh.positions:
        k = (mesh.owner(pos), mesh.device(pos), _value_key(mesh, pos, spec))
        if k not in seen:
            seen.add(k)
            out.append(pos)
    return out


def _route(mesh: Mesh, sends: list, recvs: list) -> dict:
    """Point-to-point transfers: ``sends`` are (dst rank, tag, tensor),
    ``recvs`` (src rank, tag, like): the received tensors by tag, shaped
    and typed like ``like``, on its device. Both sides list their
    transfers in one canonical order (NCCL matches them by order)."""
    dist = _dist()
    dev = _wire_device()
    bufs = {}
    ops = []
    with _Timed():
        for src, tag, like in recvs:
            buf = torch.empty(like.numel() * like.element_size(), dtype=torch.uint8, device=dev)
            bufs[tag] = (buf, like)
            ops.append((dist.irecv, buf, src, tag))
        for dst, tag, t in sends:
            ops.append((dist.isend, _to_wire(t), dst, tag))
        if dist.get_backend() == "nccl":
            works = dist.batch_isend_irecv([dist.P2POp(op, t, peer, tag=tag)
                                            for op, t, peer, tag in ops]) if ops else []
        else:
            works = [op(t, peer, tag=tag) for op, t, peer, tag in ops]
        for w in works:
            w.wait()
    return {tag: _from_wire(buf, like.dtype, like.shape, like.device)
            for tag, (buf, like) in bufs.items()}


def _kinds(mesh: Mesh, spec) -> dict:
    """Each local position's (device, value key): the positions of one
    kind hold the same values after a ppermute, and share its output."""
    return {p: (mesh.device(p), _value_key(mesh, p, spec)) for p in mesh.local_positions}


def _ppermute_local(x: ShardedArray, axis: str, shift: int) -> tuple[torch.Tensor, ...]:
    mesh = x.mesh
    made: dict = {}

    def moved(pos):
        t = x.local(_shifted(mesh, pos, axis, -shift))
        key = (id(t), mesh.device(pos))
        if key not in made:
            made[key] = t.to(mesh.device(pos))
        return made[key]

    return tuple(moved(pos) for pos in mesh.local_positions)


def _ppermute_remote(x: ShardedArray, axis: str, shift: int, shards) -> dict:
    """ppermute's transfers across processes: ``shards`` are the local
    positions' tensors; returns a fresh received tensor for each kind
    (:func:`_kinds`) of local position. Each shard has the shape of the
    one it replaces, as in JAX."""
    mesh = x.mesh
    inputs = dict(zip(mesh.local_positions, shards))
    sends, recvs, out = [], [], {}
    for r in _receivers(mesh, x.spec):
        s = _shifted(mesh, r, axis, -shift)
        if mesh.owner(r) == mesh.rank and mesh.owner(s) == mesh.rank:
            out[r] = inputs[s].to(mesh.device(r), copy=True)
        elif mesh.owner(r) == mesh.rank:
            recvs.append((mesh.owner(s), mesh.flat(r), inputs[r]))
        elif mesh.owner(s) == mesh.rank:
            sends.append((mesh.owner(r), mesh.flat(r), inputs[s]))
    got = _route(mesh, sends, recvs)
    kinds = _kinds(mesh, x.spec)
    return {kinds[r]: out[r] if r in out else got[mesh.flat(r)]
            for r in _receivers(mesh, x.spec) if mesh.owner(r) == mesh.rank}


class _PPermute(torch.autograd.Function):
    """``ppermute`` across processes, one output per kind of local
    position; the backward pass sends each kind's gradient back along
    the inverse permutation, to the shard it came from."""

    @staticmethod
    def forward(ctx, x: ShardedArray, axis: str, shift: int, *shards):
        ctx.x, ctx.axis, ctx.shift = x, axis, shift
        out = _ppermute_remote(x, axis, shift, shards)
        ctx.order = list(dict.fromkeys(_kinds(x.mesh, x.spec).values()))
        return tuple(out[k] for k in ctx.order)

    @staticmethod
    def backward(ctx, *grads):
        x, mesh = ctx.x, ctx.x.mesh
        grad_of = dict(zip(ctx.order, grads))
        kinds = _kinds(mesh, x.spec)
        sends, recvs, parts = [], [], []
        for r in _receivers(mesh, x.spec):
            s = _shifted(mesh, r, ctx.axis, -ctx.shift)
            if mesh.owner(r) == mesh.rank:
                g = grad_of[kinds[r]]
                g = torch.zeros_like(x.local(r)) if g is None else g
                if mesh.owner(s) == mesh.rank:
                    parts.append((s, g))
                else:
                    sends.append((mesh.owner(s), mesh.flat(r), g))
            elif mesh.owner(s) == mesh.rank:
                recvs.append((mesh.owner(r), mesh.flat(r), x.local(s)))
                parts.append((s, mesh.flat(r)))
        got = _route(mesh, sends, recvs)
        total: dict = {}
        for s, g in parts:
            t = x.local(s)
            g = (got[g] if isinstance(g, int) else g).to(t.device)
            total[id(t)] = g if id(t) not in total else total[id(t)] + g
        grads_in, seen = [], set()
        for t in x.shards:
            # one gradient per distinct input tensor: autograd adds a repeated input's slots
            grads_in.append(None if id(t) in seen else total.get(id(t), torch.zeros_like(t)))
            seen.add(id(t))
        return (None, None, None, *grads_in)


def ppermute(x: ShardedArray, axis: str, shift: int = 1) -> ShardedArray:
    """JAX's ``lax.ppermute`` with ``perm = [(j, (j + shift) % n)]`` over
    ``axis``: the shard at index j along ``axis`` moves to index
    j + shift. Within a process this is ``Tensor.to`` of the neighbour's
    shard (no move on a shared device), which autograd differentiates;
    across processes a :class:`torch.autograd.Function` whose backward
    pass sends each gradient back along the inverse permutation."""
    mesh = x.mesh
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r}")
    if not mesh.multiprocess or all(
            len(mesh.group_ranks(g)) == 1 for g in _groups_over(mesh, (axis,))):
        return ShardedArray(mesh, x.spec, _ppermute_local(x, axis, shift))
    kinds = _kinds(mesh, x.spec)
    outs = dict(zip(dict.fromkeys(kinds.values()), _PPermute.apply(x, axis, shift, *x.shards)))
    return ShardedArray(mesh, x.spec, tuple(outs[kinds[p]] for p in mesh.local_positions))
