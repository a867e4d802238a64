"""Multi-host inference: islands over the slow tier, and the bridge to
global arrays.

Counterpart of `genjax_tpu/parallel/multihost.py`. A multi-node run keeps
the particle axis inside a node (NVLink) and lays only the island axis
across nodes: independent SMC runs that exchange no particle, only O(1)
scalars per island (their LMLs, when pooled) — the island particle filter
(Vergé et al. 2015), which is `GridSMC` with its chain axis on the
islands.

So a multi-node run is `initialize_multihost(...)` once per process
(`torch.distributed.init_process_group`), `hybrid_mesh()`, then
`GridSMC` / `island_smc` unchanged; the islands' LMLs pool without bias
through `pooled_lml`. The node count is `world / LOCAL_WORLD_SIZE` (the
variable `torchrun` sets); one node gives JAX's single-process default, a
1 x n mesh.

`global_from_process_local` and `process_local_rows` bridge the drivers'
rank-local tensors to `DTensor`s and back; the drivers themselves stay on
plain local tensors (dispatching every eager GFI operation through
`DTensor` is not the path).
"""

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from genjax_tpu_torch.ops import logsumexp
from genjax_tpu_torch.parallel import collectives as C
from genjax_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join this process to a multi-process run: `init_process_group` with
    `init_method=coordinator_address` (`"host:port"` is read as
    `"tcp://host:port"`), `world_size=num_processes`, `rank=process_id`, over
    NCCL where a card is visible, else gloo. Returns True if the
    distributed runtime was (already) initialized with more than one
    process; with no arguments it only reports that (False when running
    single-process, where every `parallel/` API still runs on a one-rank
    group)."""
    if coordinator_address is None and num_processes is None:
        if process_id is not None:
            # A lone process_id is a misconfigured explicit launch, not a
            # query: silently ignoring it would mask the launcher's bug.
            raise ValueError(
                "initialize_multihost: process_id was given without coordinator_address/num_processes. Pass all "
                "three for an explicit setup, or none to query an initialized runtime."
            )
        return dist.is_initialized() and dist.get_world_size() > 1
    if dist.is_initialized():
        return True  # a launcher beat us to it
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes, rank=process_id)
    return True


def hybrid_mesh(
    island_devices: int | None = None,
    particle_devices: int | None = None,
    island_axis: str = "islands",
    particle_axis: str = "particles",
    device_type: str = "cuda",
) -> Mesh:
    """A 2-D `(islands, particles)` mesh whose island axis follows the
    slow tier: the particle axis never crosses a node.

    Over several nodes (ranks numbered node by node, `LOCAL_WORLD_SIZE`
    ranks each, as `torchrun` numbers them) the islands default to one per
    node and may subdivide a node. On one node the default is one island
    over every rank (1 x n), with the same axis names."""
    n = dist.get_world_size()
    nodes = n // int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if nodes > 1:
        per_node = n // nodes
        if island_devices is None:
            island_devices = nodes
        if island_devices % nodes != 0:
            raise ValueError(
                f"hybrid_mesh: island_devices={island_devices} must be a multiple of the node count ({nodes}) — "
                f"fewer islands than nodes would force the particle axis across nodes."
            )
        islands_per_node = island_devices // nodes
        if per_node % islands_per_node != 0:
            raise ValueError(
                f"hybrid_mesh: islands-per-node ({islands_per_node}) must divide the local rank count ({per_node})."
            )
        derived = per_node // islands_per_node
        if particle_devices is not None and particle_devices != derived:
            raise ValueError(
                f"hybrid_mesh: particle_devices={particle_devices} is inconsistent with "
                f"island_devices={island_devices} over {n} ranks on {nodes} nodes (expected {derived})."
            )
        # Row i of the (islands, particles) grid is ranks [i d, (i + 1) d):
        # d divides a node's rank count, so every row stays on one node.
        return make_mesh((island_devices, derived), (island_axis, particle_axis), device_type)
    if island_devices is None:
        island_devices = 1
    if particle_devices is None:
        particle_devices = n // island_devices
    return make_mesh((island_devices, particle_devices), (island_axis, particle_axis), device_type)


def island_smc(
    n_islands: int,
    n_particles: int,
    mesh: Mesh | None = None,
    island_axis: str = "islands",
    particle_axis: str = "particles",
    ess_threshold: float = 0.5,
):
    """An island particle filter over a (possibly multi-node) mesh:
    `GridSMC` with its chain axis on the island tier. Each island runs
    `n_particles`-particle SMC with island-local resampling; the slow tier
    never carries particle state."""
    from genjax_tpu_torch.parallel.grid import GridSMC

    if mesh is None:
        mesh = hybrid_mesh(island_axis=island_axis, particle_axis=particle_axis)
    return GridSMC(
        n_chains=n_islands,
        n_particles=n_particles,
        mesh=mesh,
        chain_axis=island_axis,
        particle_axis=particle_axis,
        ess_threshold=ess_threshold,
    )


def pooled_lml(per_island_lml: torch.Tensor, mesh: Mesh | None = None, axis: str = "islands") -> torch.Tensor:
    """Pool per-island log-marginal-likelihood estimates without bias:
    each island's `exp(lml_i)` estimates Z without bias, so their mean in
    density space does, `logsumexp(lml) - log(n)` (through `ops.logsumexp`,
    K1 on a card). A mean of the log estimates would keep each island's
    Jensen bias.

    With a `mesh`, `per_island_lml` is this rank's islands' estimates
    (`GridSMC.per_chain_lml`), and the islands along `axis` are gathered
    first: one all-gather of n scalars."""
    if mesh is not None:
        per_island_lml = C.all_gather(per_island_lml, mesh, axis)
    return logsumexp(per_island_lml) - math.log(per_island_lml.shape[0])


def _placements(mesh: Mesh, spec: tuple):
    from torch.distributed.tensor import Replicate, Shard

    dims = {name: d for d, name in enumerate(spec) if name is not None}
    return [Shard(dims[a]) if a in dims else Replicate() for a in mesh.axis_names]


def global_from_process_local(tree, mesh: Mesh, spec: tuple):
    """Assemble `DTensor`s from each rank's local rows. `spec` names, per
    tensor axis, the mesh axis it is split over, or None (JAX's
    `PartitionSpec`, as a tuple: `("islands", None)`); every mesh axis it
    does not name replicates. One rank's data is its own part: with a
    split leading axis, its rows. Use to restore a checkpointed collection
    onto ranks no one of which holds the whole particle state."""
    from torch.distributed.tensor import DTensor

    placements = _placements(mesh, tuple(spec))
    return torch.utils._pytree.tree_map(
        lambda v: DTensor.from_local(v, mesh.device_mesh, placements, run_check=False), tree
    )


def process_local_rows(arr) -> np.ndarray:
    """The rows this rank holds of a `DTensor` (its local part, once,
    however many mesh axes replicate it), or of a plain tensor, as a numpy
    array in host memory: for per-rank checkpoints or logs."""
    from torch.distributed.tensor import DTensor

    local = arr.to_local() if isinstance(arr, DTensor) else arr
    return local.detach().cpu().numpy()


__all__ = [
    "global_from_process_local",
    "hybrid_mesh",
    "initialize_multihost",
    "island_smc",
    "pooled_lml",
    "process_local_rows",
]
