"""Partition <-> sharding translation on ``torch.distributed`` (counterpart
of ``superbblas_tpu/parallel/mesh.py``).

The JAX package realises a partition as a ``NamedSharding`` over a
``Mesh`` whose axis names are the distributed lattice labels.  Here the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those labels as
``mesh_dim_names``, and a sharded array is a ``DTensor`` (a ``CArray`` of
two).  ``PartitionSpec`` and ``NamedSharding`` are small frozen classes
with the JAX fields (a spec names a mesh axis, or None, per array axis);
``NamedSharding.placements()`` gives the DTensor placements, and
``boxes(shape)`` the (from, size) box each rank holds, in rank order.

A mesh that only describes a rank layout (``partition_sharding`` without
a ``mesh``) is a ``RankGrid``: the same fields as a ``DeviceMesh`` and no
process groups, turned into a ``DeviceMesh`` by :func:`device_mesh` when
data has to move on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..labels import volume
from .partition import Partition

__all__ = ["PartitionSpec", "NamedSharding", "SingleDeviceSharding", "RankGrid",
           "make_mesh", "partition_sharding", "sharding_partition", "sharding_of",
           "device_mesh", "axis_size"]


class PartitionSpec(tuple):
    """Per array axis, the mesh axis name that shards it, a tuple of names
    (the axis split over their product, the first major), or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class RankGrid:
    """A rank layout with named axes: ``ranks`` holds the global rank of
    each mesh coordinate (row-major, shape ``shape``)."""

    ranks: Tuple[int, ...]
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    device_type: str = "cuda"

    @property
    def mesh(self) -> torch.Tensor:
        return torch.tensor(self.ranks, dtype=torch.int64).reshape(self.shape)

    def size(self, mesh_dim: int = 0) -> int:
        return self.shape[mesh_dim]


def axis_size(mesh, name: str) -> int:
    """Extent of the mesh axis ``name`` (1 where the mesh lacks it)."""
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def _mesh_ranks(mesh) -> np.ndarray:
    return np.asarray(mesh.mesh.cpu().numpy() if isinstance(mesh.mesh, torch.Tensor)
                      else mesh.mesh, dtype=np.int64)


@dataclass(frozen=True)
class NamedSharding:
    """An array sharded as ``spec`` over ``mesh`` (a DeviceMesh or a
    RankGrid)."""

    mesh: object
    spec: PartitionSpec

    def _names(self, entry) -> tuple:
        """The mesh axes of one spec entry, major first: () for None, one
        name, or a tuple of names (the array axis split over their
        product)."""
        return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)

    def placements(self):
        """The DTensor placements: per mesh dimension, ``Shard(axis)`` of
        the array axis the spec gives it, else ``Replicate()``.  An entry
        naming several mesh axes gives each a ``Shard`` of that axis
        (DTensor nests them in the mesh's order, so the entry must name
        them in that order)."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        for e in self.spec:
            got = self._names(e)
            if len(got) > 1 and list(got) != sorted(got, key=names.index):
                raise NotImplementedError(
                    f"spec entry {e}: DTensor nests the shards of one array axis in the "
                    f"mesh's order {names}; name them so")
        out = []
        for name in names:
            axes = [i for i, e in enumerate(self.spec) if name in self._names(e)]
            out.append(Shard(axes[0]) if axes else Replicate())
        return out

    def boxes(self, shape) -> list:
        """(from, size) of the block each rank of the mesh holds, in rank
        order (DTensor's chunking: ceil(d / n) per shard, the last ones
        smaller or empty; an axis split over several mesh axes is cut by
        the first, each piece by the next, and so on, as DTensor nests
        them and as the JAX package's ``devices_indices_map`` gives them
        where the extents divide)."""
        shape = tuple(int(d) for d in shape)
        ranks = _mesh_ranks(self.mesh)
        names = tuple(self.mesh.mesh_dim_names)
        for e in self.spec:
            if e is not None and not isinstance(e, (str, tuple, list)):
                raise NotImplementedError("a spec entry names mesh axes or None")
            for s in self._names(e):
                if s not in names:
                    raise ValueError(f"spec names {s!r}, not an axis of the mesh {names}")
        out = {}
        for coord in np.ndindex(*ranks.shape):
            frm, size = [], []
            for i, d in enumerate(shape):
                f, z = 0, d
                for s in self._names(self.spec[i] if i < len(self.spec) else None):
                    m = names.index(s)
                    chunk = -(-z // ranks.shape[m])
                    lo = min(coord[m] * chunk, z)
                    f, z = f + lo, max(0, min(chunk, z - lo))
                frm.append(f if z else 0)
                size.append(z)
            if volume(size) == 0:
                frm = [0] * len(shape)
            out[int(ranks[coord])] = (tuple(frm), tuple(size))
        return [out[r] for r in sorted(out)]


@dataclass(frozen=True)
class SingleDeviceSharding:
    """The whole array on one rank ("on master")."""

    rank: int = 0

    def boxes(self, shape) -> list:
        return [((0,) * len(shape), tuple(int(d) for d in shape))]


def make_mesh(axis_sizes: dict, devices=None):
    """A DeviceMesh with axes named by lattice labels.

    ``axis_sizes`` maps label -> number of shards, e.g. {"x": 2, "y": 4}.
    ``devices``: the device type, "cuda" (the default: NCCL) or "cpu"
    (gloo), or a sequence of global ranks.  The process group is
    initialised (one process) where it is not yet; a CUDA mesh raises
    without a card."""
    from torch.distributed.device_mesh import DeviceMesh

    from .multihost import _default_device, initialize_distributed

    device_type = devices if isinstance(devices, str) else None
    device_type = _default_device(device_type)
    initialize_distributed(device=device_type)
    import torch.distributed as dist

    shape = tuple(int(v) for v in axis_sizes.values())
    n = volume(shape)
    world = dist.get_world_size()
    ranks = (list(range(world)) if devices is None or isinstance(devices, str)
             else [int(r) for r in devices])
    if n > len(ranks):
        raise ValueError(f"mesh needs {n} ranks, only {len(ranks)} available")
    mesh = torch.tensor(ranks[:n], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axis_sizes.keys()))


_DEVICE_MESHES: dict = {}


def device_mesh(mesh):
    """A DeviceMesh for ``mesh`` (itself when it is one; a RankGrid's is
    built once, collectively)."""
    if not isinstance(mesh, RankGrid):
        return mesh
    dm = _DEVICE_MESHES.get(mesh)
    if dm is None:
        from torch.distributed.device_mesh import DeviceMesh

        dm = _DEVICE_MESHES[mesh] = DeviceMesh(mesh.device_type, mesh.mesh,
                                               mesh_dim_names=mesh.mesh_dim_names)
    return dm


def partition_sharding(
    part: Partition,
    order: str,
    devices: Optional[Sequence] = None,
    mesh=None,
):
    """NamedSharding equivalent of a regular grid partition, or None.

    Only grid partitions (the output of ``basic_partitioning`` without
    halo) whose every axis extent divides by its grid size map to a
    sharding; uneven grids and halo'd or overlapping partitions give
    None, as in the JAX package.  A replicated partition maps to a
    replicated sharding; a partition whose only nonempty box is rank 0's
    full box ("on master") maps to a ``SingleDeviceSharding``.  Without a
    ``mesh`` the sharding's mesh is a ``RankGrid`` whose rank layout
    follows the partition's rank scan; ``devices`` is its device type
    ("cuda" unless given)."""
    device_type = devices if isinstance(devices, str) else "cuda"
    nd = len(part.dim)
    full = ((0,) * nd, part.dim)

    nonempty = [i for i, b in enumerate(part.boxes) if volume(b[1]) > 0]
    if nonempty == [0] and part.boxes[0] == full:
        return SingleDeviceSharding(0)

    if part.is_replicated():
        if mesh is None:
            n = len(part.boxes)
            mesh = RankGrid(tuple(range(n)), (n,), ("_r",), device_type)
        return NamedSharding(mesh, PartitionSpec())

    grid = part.grid_shape()
    if grid is None:
        return None
    for d, g in zip(part.dim, grid):
        if g > 1 and d % g != 0:
            return None

    if mesh is None:
        axis_labels = [order[i] for i in range(nd) if grid[i] > 1]
        if not axis_labels:
            return NamedSharding(RankGrid((0,), (1,), ("_r",), device_type),
                                 PartitionSpec())
        starts = [sorted({b[0][i] for b in part.boxes}) for i in range(nd)]
        shape = tuple(g for g in grid if g > 1)
        arr = np.empty(shape, dtype=np.int64)
        for r, b in enumerate(part.boxes[: volume(grid)]):
            arr[tuple(starts[i].index(b[0][i]) for i in range(nd) if grid[i] > 1)] = r
        mesh = RankGrid(tuple(int(v) for v in arr.reshape(-1)), shape,
                        tuple(axis_labels), device_type)

    names = tuple(mesh.mesh_dim_names)
    spec = PartitionSpec(*[(order[i] if grid[i] > 1 and order[i] in names else None)
                           for i in range(nd)])
    return NamedSharding(mesh, spec)


def sharding_of(x) -> NamedSharding:
    """The NamedSharding of a DTensor (or a CArray of DTensors): its mesh
    and, per array axis, the mesh axis that shards it."""
    from torch.distributed.tensor import Replicate, Shard

    from .. import cplx

    a = x.re if cplx.is_carray(x) else x
    spec = [None] * a.ndim
    for name, p in zip(a.device_mesh.mesh_dim_names, a.placements):
        if isinstance(p, Shard):
            # a second mesh axis on one array axis nests inside the first
            spec[p.dim] = name if spec[p.dim] is None else (
                (spec[p.dim],) if isinstance(spec[p.dim], str) else spec[p.dim]) + (name,)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} has no partition (reduce it first)")
    return NamedSharding(a.device_mesh, PartitionSpec(*spec))


def sharding_partition(sharding, shape) -> Partition:
    """Partition metadata (a box per rank) of a sharding or of a DTensor —
    the inverse translation, used by storage manifests and the
    redistribution of sharded arrays."""
    if not isinstance(sharding, (NamedSharding, SingleDeviceSharding)):
        sharding = sharding_of(sharding)
    return Partition(dim=tuple(int(d) for d in shape),
                     boxes=tuple(sharding.boxes(shape)))
