"""The mesh record and the leading-axis split of particle state.

Counterpart of `genjax_tpu/parallel/mesh.py`. A JAX mesh names the axes
of an array of devices that one process drives. In torch each rank is a
process that holds its own rows, so a `Mesh` names the axes of an array
of ranks: it wraps a `torch.distributed.device_mesh.DeviceMesh` and gives,
per axis name, its size (`.shape[axis]`), this rank's coordinate
(`.rank(axis)`) and the process group of the ranks that differ from this
one along it (`.group(axis)`), which every collective of the layer names.

`constrain_leading_axis` is mapped, not ported: it is a sharding
constraint for XLA's SPMD partitioner inside `jit`, and torch has no
partitioner. The drivers take and return each rank's own rows instead,
so nothing needs constraining.
"""

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named array of ranks (`DeviceMesh`) with JAX's axis names
    (`"particles"`, `"chains"`, `"replicas"`, `"islands"`).

    Each axis's size, this rank's coordinate and the axis's process group
    and backend are read from the `DeviceMesh` once, when the record is
    made: reading them there costs tens of microseconds per call, and
    every collective reads them."""

    device_mesh: DeviceMesh
    shape: dict = dataclasses.field(init=False, compare=False)
    _ranks: dict = dataclasses.field(init=False, repr=False, compare=False)
    _groups: dict = dataclasses.field(init=False, repr=False, compare=False)
    _backends: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        names = tuple(self.device_mesh.mesh_dim_names)
        groups = {a: self.device_mesh.get_group(a) for a in names}
        # Axis name -> number of ranks along it, as JAX's `mesh.shape`.
        object.__setattr__(self, "shape", dict(zip(names, self.device_mesh.mesh.shape)))
        object.__setattr__(self, "_ranks", {a: self.device_mesh.get_local_rank(a) for a in names})
        object.__setattr__(self, "_groups", groups)
        object.__setattr__(self, "_backends", {a: dist.get_backend(g) for a, g in groups.items()})

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str) -> dist.ProcessGroup:
        """The process group of the ranks along `axis` through this rank."""
        return self._groups[axis]

    def backend(self, axis: str) -> str:
        return self._backends[axis]

    def rank(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self._ranks[axis]

    def flat_rank(self) -> int:
        """This rank's position in the mesh, row-major over the axes: the
        index of its per-row generator among `fork(rng, mesh.size)`."""
        r = 0
        for axis in self.axis_names:
            r = r * self.shape[axis] + self.rank(axis)
        return r


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], device_type: str = "cuda") -> Mesh:
    """A `Mesh` of `shape` over every rank of the default process group
    (which must be initialized), ranks laid out row-major."""
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} ranks; the group has {world}")
    return Mesh(init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names)))


def particle_mesh(n_devices: int | None = None, axis_name: str = "particles", device_type: str = "cuda") -> Mesh:
    """A 1-D mesh over every rank of the process group, named for the
    particle (or chain) axis. `n_devices`, where given, must be the group's
    size: a torch mesh covers the whole group."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return make_mesh((n,), (axis_name,), device_type)


def _rows(v: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    if v.shape[0] % n:
        raise ValueError(f"shard_leading_axis: {v.shape[0]} rows do not divide over {n} ranks")
    per = v.shape[0] // n
    return v.narrow(0, rank * per, per).clone()


def shard_leading_axis(tree, mesh: Mesh, axis_name: str = "particles"):
    """This rank's rows `[rank K/n, (rank + 1) K/n)` of every leaf of `tree`
    that carries the leading particle (or chain) axis; every other leaf
    whole.

    Inside a trace or a choice map the tree's own record
    (`batched_leaves`) says which leaves carry the axis, so a shared
    argument of any length (a design matrix with K rows among them) stays
    whole. Any other tensor leaf with at least one axis is split, 0-d
    leaves are shared, as JAX places them."""
    n, rank = mesh.shape[axis_name], mesh.rank(axis_name)

    def split(node):
        if hasattr(node, "batched_leaves"):
            leaves, spec = pytree.tree_flatten(node)
            bits = node.batched_leaves()
            return pytree.tree_unflatten([_rows(v, rank, n) if b else v for v, b in zip(leaves, bits)], spec)
        if isinstance(node, torch.Tensor) and node.dim() >= 1:
            return _rows(node, rank, n)
        return node

    return pytree.tree_map(split, tree, is_leaf=lambda x: hasattr(x, "batched_leaves"))


__all__ = ["Mesh", "make_mesh", "particle_mesh", "shard_leading_axis"]
