"""2-D mesh inference: independent SMC runs (chains) × particles.

Counterpart of `genjax_tpu/parallel/grid.py`. A `(chains, particles)`
mesh of ranks carries a `(C, K)` grid of particles: C independent SMC
runs of K particles each. Rank `(c, p)` holds the `C / n_c` runs of its
chain coordinate and, of each, the `K / n_p` particles of its particle
coordinate. Per-chain reductions (LML, ESS) and resampling ride the
particle group only; the chain group carries nothing.

Layout: the rank's particles are one trace whose particle axis holds its
`C_l x K_l` grid cells chain-major (cell `(c, k)` is row `c K_l + k`), so
the dense port's GFI, `mh` and edits run on it unchanged; the log weights
are `(C_l, K_l)`. Shared leaves (model arguments, observations) are
stored once, whatever their length: the trace's record says so, where
JAX guessed from leading dimensions and kept colliding leaves in
broadcast form (`grid.py:118-122`).

Randomness as in `parallel/smc.py`: rank `(c, p)` draws its rows from
`fork(rng, n_c n_p)[c n_p + p]`; the systematic uniforms, one per chain,
come from the replicated generator.
"""

import math
from typing import Generic, TypeVar

import torch

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.inference.smc import ParticleCollection, SMCDriver
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess
from genjax_tpu_torch.parallel import collectives as C
from genjax_tpu_torch.parallel.mesh import Mesh, make_mesh
from genjax_tpu_torch.parallel.smc import (
    _ess_from,
    _lml_from,
    _shard_sums,
    exchange_rows,
    systematic_slot_ancestors,
)

R = TypeVar("R")


def grid_mesh(
    chain_devices: int | None = None,
    particle_devices: int | None = None,
    chain_axis: str = "chains",
    particle_axis: str = "particles",
    device_type: str = "cuda",
) -> Mesh:
    """A 2-D `(chains, particles)` mesh over every rank of the process
    group. Defaults to 2 x (n/2) (1 x n on one rank)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if chain_devices is None:
        chain_devices = 2 if n >= 2 else 1
    if particle_devices is None:
        particle_devices = n // chain_devices
    return make_mesh((chain_devices, particle_devices), (chain_axis, particle_axis), device_type)


def _rows_lse_ess(lw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's (log-sum-exp, ESS): one K1 launch per row (K1 takes one
    vector, so a reduction costs C_l launches and stacks)."""
    pairs = [logsumexp_ess(row) for row in lw]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


@Pytree.dataclass
class GridSMC(Generic[R], Pytree):
    """C independent SMC runs of K particles on a `(chains, particles)`
    mesh of ranks. Every method takes and returns this rank's part of the
    grid (see the module docstring); all reductions are per chain and ride
    the particle group."""

    n_chains: int = Pytree.static()
    n_particles: int = Pytree.static()
    mesh: Mesh = Pytree.static()
    chain_axis: str = Pytree.static(default="chains")
    particle_axis: str = Pytree.static(default="particles")
    ess_threshold: float = Pytree.static(default=0.5)

    def _dims(self) -> tuple[int, int]:
        """(chains, particles per chain) on this rank."""
        nc, np_ = self.mesh.shape[self.chain_axis], self.mesh.shape[self.particle_axis]
        if self.n_chains % nc or self.n_particles % np_:
            raise ValueError(
                f"GridSMC: {self.n_chains} chains x {self.n_particles} particles do not divide over a "
                f"{nc} x {np_} mesh"
            )
        return self.n_chains // nc, self.n_particles // np_

    def _stream(self, rng: torch.Generator) -> torch.Generator:
        return fork(rng, self.mesh.size)[self.mesh.flat_rank()]

    def _dense(self) -> SMCDriver:
        c, k = self._dims()
        return SMCDriver(n_particles=c * k, ess_threshold=self.ess_threshold)

    def _flat(self, collection: ParticleCollection[R]) -> ParticleCollection[R]:
        lw = collection.get_log_weights().reshape(-1)
        return ParticleCollection(collection.get_particles(), lw, collection.is_valid)

    def _grid(self, collection: ParticleCollection[R]) -> ParticleCollection[R]:
        return ParticleCollection(
            collection.get_particles(), collection.get_log_weights().reshape(self._dims()), collection.is_valid
        )

    # -- lifecycle ---------------------------------------------------------

    def init(self, rng: torch.Generator, target: Target[R]) -> ParticleCollection[R]:
        return self._grid(self._dense().init(self._stream(rng), target))

    def per_chain_lml(self, collection: ParticleCollection[R]) -> torch.Tensor:
        """This rank's chains' log marginal likelihood estimates, `(C_l,)`."""
        m, s = _shard_sums(*_rows_lse_ess(collection.get_log_weights()), self.mesh, self.particle_axis)
        return _lml_from(m, s, self.n_particles)

    def per_chain_ess(self, collection: ParticleCollection[R]) -> torch.Tensor:
        """This rank's chains' effective sample sizes, `(C_l,)`."""
        _, s = _shard_sums(*_rows_lse_ess(collection.get_log_weights()), self.mesh, self.particle_axis)
        return _ess_from(s)

    # -- resampling ---------------------------------------------------------

    def _uniforms(self, rng: torch.Generator) -> torch.Tensor:
        """This rank's chains' systematic uniforms: all C drawn from the
        replicated generator (so every rank keeps it in step), its own
        kept."""
        c_l, _ = self._dims()
        u = torch.rand(self.n_chains, generator=rng, device=rng.device)
        return u[self.mesh.rank(self.chain_axis) * c_l :][:c_l]

    def _gathered(self, lw: torch.Tensor) -> torch.Tensor:
        """(C_l, K): each of this rank's chains' K weights, gathered over the
        particle group in rank order."""
        c_l, k_l = lw.shape
        if self.mesh.shape[self.particle_axis] == 1:
            return lw
        gathered = C.all_gather(lw, self.mesh, self.particle_axis)
        return gathered.reshape(-1, c_l, k_l).transpose(0, 1).reshape(c_l, -1)

    def _resample(self, u0: torch.Tensor, collection: ParticleCollection[R], local_lse=None) -> ParticleCollection[R]:
        c_l, k_l = self._dims()
        lw_all = self._gathered(collection.get_log_weights())
        if local_lse is not None and self.mesh.shape[self.particle_axis] == 1:
            # The rows are the local ones: the gate's K1 pairs gave their lse.
            lse = local_lse
        else:
            lse = torch.stack([logsumexp(row) for row in lw_all])
        lo = self.mesh.rank(self.particle_axis) * k_l
        anc = systematic_slot_ancestors(u0, lw_all, lo, lo + k_l, lse)
        particles = exchange_rows(collection.get_particles(), anc, self.mesh, self.particle_axis)
        avg = (lse - math.log(self.n_particles))[:, None].expand(c_l, k_l).contiguous()
        return ParticleCollection(particles, avg, collection.is_valid)

    def resample(self, rng: torch.Generator, collection: ParticleCollection[R]) -> ParticleCollection[R]:
        """Systematic resampling of each chain on its own (one uniform per
        chain from the replicated generator); each chain's weights become
        its mean weight."""
        return self._resample(self._uniforms(rng), collection)

    def maybe_resample(self, rng: torch.Generator, collection: ParticleCollection[R]) -> ParticleCollection[R]:
        """Resample each chain whose own ESS (all-reduced over its particle
        group) is below `ess_threshold * n_particles`; the other chains and
        every shared leaf are left as they are. The uniforms are drawn
        whether or not a chain resamples."""
        u0 = self._uniforms(rng)
        lse, ess = _rows_lse_ess(collection.get_log_weights())
        _, s = _shard_sums(lse, ess, self.mesh, self.particle_axis)
        do = _ess_from(s) < self.ess_threshold * self.n_particles
        # Every rank of this particle group holds the same `do` (from one
        # all-reduce): they take the branch, and its collectives, together.
        if not bool(do.any()):
            return collection
        resampled = self._resample(u0, collection, lse)
        _, k_l = self._dims()
        particles = where_tree(do.repeat_interleave(k_l), resampled.get_particles(), collection.get_particles())
        lw = torch.where(do[:, None], resampled.get_log_weights(), collection.get_log_weights())
        return ParticleCollection(particles, lw, collection.is_valid)

    # -- moves ---------------------------------------------------------------

    def extend(
        self,
        rng: torch.Generator,
        collection: ParticleCollection[R],
        constraint: ChoiceMap,
        argdiffs: tuple | None = None,
    ) -> ParticleCollection[R]:
        return self._grid(self._dense().extend(self._stream(rng), self._flat(collection), constraint, argdiffs))

    def rejuvenate(self, rng: torch.Generator, collection: ParticleCollection[R], request) -> ParticleCollection[R]:
        return self._grid(self._dense().rejuvenate(self._stream(rng), self._flat(collection), request))


__all__ = ["GridSMC", "grid_mesh"]
