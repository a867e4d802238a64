"""Multi-device scaling on `torch.distributed`: particle, chain, replica
and island axes spread over a mesh of ranks.

Counterpart of `genjax_tpu/parallel/`. JAX runs one process over a device
mesh inside `shard_map`; torch runs one process per rank, so the per-shard
body is the API: every driver takes and returns this rank's rows, draws
per-row randomness from its own fork of a generator that every rank seeds
the same (`adev.core.fork(rng, n)[rank]`), and reduces across ranks with
the collectives of `parallel/collectives.py`, each on a named mesh axis
and counted (`collectives.stats()`). `parallel/launch.py` spawns the ranks
of a run on one host; `parallel/certify.py` holds the stitched dense
references and the rank bodies that the tests, `entry.dryrun_multichip`
and `chip_smoke.py` run. `parallel/data.py::data_sharded` splits a
model's observations over the ranks (the counterpart of a sharded data
operand under GSPMD); the warmups take a `mesh` of their own
(`inference/adaptation.py`).

Importing this package touches no process group: every function that
needs one takes its `Mesh`.
"""

from genjax_tpu_torch.parallel.chains import sharded_mh_chains
from genjax_tpu_torch.parallel.data import data_sharded
from genjax_tpu_torch.parallel.grid import GridSMC, grid_mesh
from genjax_tpu_torch.parallel.mesh import particle_mesh, shard_leading_axis
from genjax_tpu_torch.parallel.multihost import (
    global_from_process_local,
    hybrid_mesh,
    initialize_multihost,
    island_smc,
    pooled_lml,
    process_local_rows,
)
from genjax_tpu_torch.parallel.pt import sharded_pt_run
from genjax_tpu_torch.parallel.smc import (
    ShardedSMC,
    sharded_ess,
    sharded_lml,
    sharded_systematic_ancestors,
)
from genjax_tpu_torch.parallel.svgd import sharded_stein_direction, sharded_svgd

__all__ = [
    "GridSMC",
    "ShardedSMC",
    "data_sharded",
    "sharded_stein_direction",
    "sharded_svgd",
    "global_from_process_local",
    "grid_mesh",
    "hybrid_mesh",
    "initialize_multihost",
    "island_smc",
    "particle_mesh",
    "pooled_lml",
    "process_local_rows",
    "shard_leading_axis",
    "sharded_ess",
    "sharded_lml",
    "sharded_mh_chains",
    "sharded_pt_run",
    "sharded_systematic_ancestors",
]
