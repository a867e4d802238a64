"""Sharded SMC: the particle axis spans the ranks of a mesh axis.

Counterpart of `genjax_tpu/parallel/smc.py`. JAX writes the per-shard
body once inside `shard_map`; here that body is the API. Each rank holds
its own rows `[rank K/n, (rank + 1) K/n)` of every per-particle leaf (the
trace's record says which leaves those are; shared leaves are whole on
every rank), and every function takes and returns rank-local tensors and
traces.

* Weight reductions (LML, ESS) reduce the local shard with one launch of
  K1 (`ops.logsumexp_ess`), then combine the shards with one max
  all-reduce of the local log-sum-exps and one sum all-reduce of a
  2-vector per shard: the shifted sums of the weights and of their
  squares.
* Systematic resampling all-gathers the K log weights only (4 K bytes)
  and computes this rank's slots' ancestors from the float64 cdf of the
  dense port (`inference/smc.py::prefix_cdf`). Systematic ancestors are
  monotone, so at healthy ESS a rank's sources lie in its own block and
  its two neighbours': the rows move by one neighbour exchange (one packed
  buffer per dtype, each sent to both neighbours). Where some rank needs
  rows from further away (`n_far`, a sum all-reduce, so every rank takes
  the same branch) the rows are all-gathered for that call only. On one
  rank there is no exchange: the dense resampler runs.

Randomness: a driver takes one generator that the caller seeds the same
on every rank (the replicated generator, JAX's same key on all shards). It
draws what every rank must agree on (the systematic `u0`) and forks the
per-row streams: rank r draws its rows from `adev.core.fork(rng, n)[r]`.
So a sharded run equals, block by block, the dense driver run on each
block with its fork (the stitched dense run, `parallel/certify.py`).

JAX's `lax.cond`s are host `if`s, and each reads a value that came out of
an all-reduce (the ESS, `n_far`), never a local one: a rank that branched
alone would leave the others waiting in a collective.
`share_constrained_values` stays unported, as in the dense port.
"""

import math
from typing import Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.gather import batched_mask
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.inference.smc import ParticleCollection, SMCDriver, systematic_cum_counts
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess
from genjax_tpu_torch.parallel import collectives as C
from genjax_tpu_torch.parallel.mesh import Mesh

R = TypeVar("R")


def _shard_sums(lse: torch.Tensor, ess: torch.Tensor, mesh: Mesh, axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """`(M, S)` from each shard's log-sum-exp and ESS (one value per row
    of a batch of rows, or 0-d): `M` the max over the shards, `S` the sums
    over the shards of `exp(lse - M)` and of each shard's sum of squared
    weights shifted the same way, `exp(2 lse - log ess - 2 M)`, stacked on
    a leading axis of 2 and summed in float64 (the shards' float32 pairs
    combined with no rounding of their own). A shard whose weights are all
    `-inf` adds 0 to both (its ESS is NaN, R2); where every shard is
    `-inf`, `M` is `-inf` and the sums are NaN."""
    m = C.all_reduce(lse.clone(), mesh, axis, "max")
    lse64, m64 = lse.double(), m.double()
    empty = lse == -torch.inf
    s1 = torch.where(empty, 0.0, torch.exp(lse64 - m64))
    s2 = torch.where(empty, 0.0, torch.exp(2.0 * lse64 - torch.log(ess.double()) - 2.0 * m64))
    return m, C.all_reduce(torch.stack([s1, s2]), mesh, axis, "sum")


def _lml_from(m: torch.Tensor, s: torch.Tensor, n_total: int) -> torch.Tensor:
    """`M + log S1 - log K` in float32 (on one rank `S1` is 1 and this is
    the dense port's `logsumexp - log K` to the bit); `M` itself where it
    is infinite (every shard `-inf`: `-inf`, as the dense `logsumexp`
    gives)."""
    return torch.where(torch.isinf(m), m, m + torch.log(s[0]).float() - math.log(n_total))


def _ess_from(s: torch.Tensor) -> torch.Tensor:
    return (s[0] * s[0] / s[1]).float()


def _lml_ess(log_weights: torch.Tensor, mesh: Mesh, axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(LML, ESS) of the sharded weight vector: one K1 launch on the local
    shard, one max and one sum all-reduce."""
    lse, ess = logsumexp_ess(log_weights)
    m, s = _shard_sums(lse, ess, mesh, axis)
    return _lml_from(m, s, log_weights.shape[0] * mesh.shape[axis]), _ess_from(s)


def sharded_lml(log_weights: torch.Tensor, mesh: Mesh, axis: str = "particles") -> torch.Tensor:
    """The log marginal likelihood estimate `logsumexp(w) - log K` of the
    weight vector whose shards the ranks along `axis` hold: the same 0-d
    tensor on every rank."""
    return _lml_ess(log_weights, mesh, axis)[0]


def sharded_ess(log_weights: torch.Tensor, mesh: Mesh, axis: str = "particles") -> torch.Tensor:
    """The effective sample size `(sum w)^2 / sum w^2` of the sharded
    weight vector, from the same reduction as `sharded_lml`."""
    return _lml_ess(log_weights, mesh, axis)[1]


def systematic_slot_ancestors(
    u0, log_weights: torch.Tensor, lo: int, hi: int, lse=None
) -> torch.Tensor:
    """The ancestors of the output slots `[lo, hi)` of systematic
    resampling over all K `log_weights` with the uniform `u0`: rows
    `[lo, hi)` of the dense port's
    `cum_counts_to_ancestors(systematic_cum_counts(u0, w, K, lse), K)`,
    from the same float64 cdf (a slot never goes to a particle of zero
    weight). Over a batch of rows `(R, K)`, `u0` and `lse` hold one value
    per row. `lse` as in `inference/smc.py::normalized_cdf`."""
    n = log_weights.shape[-1]
    cum = systematic_cum_counts(u0, log_weights, n, lse)
    slots = torch.arange(lo, hi, device=cum.device, dtype=cum.dtype).expand(*cum.shape[:-1], hi - lo)
    return torch.searchsorted(cum, torch.minimum(slots, cum[..., -1:] - 1).contiguous(), right=True)


def _gathered_ancestors(rng: torch.Generator, log_weights: torch.Tensor, mesh: Mesh, axis: str):
    """(this rank's slots' ancestors, `logsumexp` of all K weights): one
    all-gather of the weights, one K1 launch on them, one uniform of the
    replicated generator."""
    per = log_weights.shape[0]
    lw_all = C.all_gather(log_weights, mesh, axis)
    lse = logsumexp(lw_all)
    u0 = torch.rand((), generator=rng, device=rng.device)
    lo = mesh.rank(axis) * per
    return systematic_slot_ancestors(u0, lw_all, lo, lo + per, lse), lse


def sharded_systematic_ancestors(
    rng: torch.Generator, log_weights: torch.Tensor, mesh: Mesh, axis: str = "particles"
) -> torch.Tensor:
    """Distributed systematic resampling: this rank's output slots' global
    ancestor indices. Only the K log weights are all-gathered; `u0` comes
    from the replicated generator `rng`, so every rank uses the same."""
    return _gathered_ancestors(rng, log_weights, mesh, axis)[0]


def _pack(leaves: list, bits: list, rows: int) -> list:
    """`[(indices, buffer)]`, one per dtype: the per-particle leaves of that
    dtype (their indices among `leaves`), each flattened behind its `rows`
    leading rows and laid side by side in one `(rows, F)` buffer."""
    groups: dict = {}
    for i, (v, b) in enumerate(zip(leaves, bits)):
        if b:
            groups.setdefault(v.dtype, []).append(i)
    return [(idx, torch.cat([leaves[i].reshape(rows, -1) for i in idx], 1)) for idx in groups.values()]


def exchange_rows(tree, ancestors: torch.Tensor, mesh: Mesh, axis: str = "particles"):
    """Every per-particle leaf of `tree` (a trace or a choice map, its rows
    this rank's) with row s replaced by global row `ancestors[s]`; shared
    leaves pass through.

    `ancestors` is `(per,)`, or `(C, per)` for C independent runs whose
    particles the leaves hold chain-major (`GridSMC`), each row indexing
    its own run's particles. Monotone ancestors (systematic ones) that
    stay within a rank's neighbours take the neighbour exchange; otherwise,
    as every rank learns from one sum all-reduce of the far hops, the rows
    are all-gathered (`gather_rows`). With one rank on the axis the rows
    are all local."""
    anc = ancestors.reshape(-1, ancestors.shape[-1])
    if mesh.shape[axis] == 1:
        return _moved(tree, anc, mesh, axis, "local")
    hops = torch.div(anc, anc.shape[-1], rounding_mode="floor") - mesh.rank(axis)
    n_far = C.all_reduce((hops.abs() > 1).sum(), mesh, axis, "sum")
    return _moved(tree, anc, mesh, axis, "near" if int(n_far) == 0 else "far")


def gather_rows(tree, ancestors: torch.Tensor, mesh: Mesh, axis: str = "particles"):
    """`exchange_rows`'s fallback on its own: every rank's rows
    all-gathered (one gather per dtype), then this rank's ancestors taken
    from them, however far."""
    return _moved(tree, ancestors.reshape(-1, ancestors.shape[-1]), mesh, axis, "far")


def _moved(tree, anc: torch.Tensor, mesh: Mesh, axis: str, path: str):
    n_runs, per = anc.shape
    rank = mesh.rank(axis)
    leaves, spec, bits = batched_mask(tree)
    packed = _pack(leaves, bits, n_runs * per)
    bufs = [buf.reshape(n_runs, per, -1) for _, buf in packed]
    if path == "local":
        windows, local = bufs, anc
    elif path == "near":
        pairs = C.exchange(bufs, mesh, axis)
        windows = [torch.cat([lf, mine, rt], 1) for mine, (lf, rt) in zip(bufs, pairs)]
        local = anc - (rank - 1) * per
    else:
        # (n runs per, F) -> (runs, n per, F): each run's rows in global order.
        windows = [
            C.all_gather(b, mesh, axis).reshape(-1, n_runs, per, b.shape[-1]).transpose(0, 1)
            .reshape(n_runs, -1, b.shape[-1])
            for b in bufs
        ]
        local = anc
    out = list(leaves)
    for (idx, _), window in zip(packed, windows):
        flat = (local + window.shape[1] * torch.arange(n_runs, device=anc.device)[:, None]).reshape(-1)
        taken = window.reshape(-1, window.shape[-1]).index_select(0, flat)
        col = 0
        for i in idx:
            f = leaves[i].numel() // (n_runs * per)
            out[i] = taken[:, col : col + f].reshape(leaves[i].shape)
            col += f
    return pytree.tree_unflatten(out, spec)


def sharded_systematic_exchange(
    rng: torch.Generator, log_weights: torch.Tensor, rows, mesh: Mesh, axis: str = "particles"
):
    """Distributed systematic resampling of `rows` (a trace or a choice
    map): only the K-float weight vector is all-gathered, the rows ride the
    neighbour exchange (or, where some rank needs rows from further away,
    an all-gather). With one rank on the axis the dense row gather runs."""
    anc, _ = _gathered_ancestors(rng, log_weights, mesh, axis)
    return exchange_rows(rows, anc, mesh, axis)


@Pytree.dataclass
class ShardedSMC(Generic[R], Pytree):
    """SMC whose particle axis spans the ranks along `mesh[axis]`: `init`,
    `lml`, `ess`, `extend`, `resample`, `maybe_resample`, `rejuvenate`,
    each on this rank's block of `n_particles / n` particles with the
    dense `SMCDriver`'s semantics, the reductions and the resampling
    across ranks.

    Every method takes the replicated generator. `init`, `extend` and
    `rejuvenate` fork it once into one stream per rank (`fork(rng, n)`)
    and run the dense driver on this rank's block with its stream; the
    resampler draws its one uniform from it."""

    n_particles: int = Pytree.static()
    mesh: Mesh = Pytree.static()
    axis: str = Pytree.static(default="particles")
    resampling: str = Pytree.static(default="systematic")
    ess_threshold: float = Pytree.static(default=0.5)

    def _n(self) -> int:
        n = self.mesh.shape[self.axis]
        if self.n_particles % n:
            raise ValueError(f"ShardedSMC: {self.n_particles} particles do not divide over {n} ranks")
        if self.resampling != "systematic":
            raise ValueError("ShardedSMC resamples systematically (its exchange relies on monotone ancestors)")
        return n

    def _local(self) -> SMCDriver:
        return SMCDriver(self.n_particles // self._n(), self.resampling, self.ess_threshold)

    def _stream(self, rng: torch.Generator) -> torch.Generator:
        return fork(rng, self._n())[self.mesh.rank(self.axis)]

    def init(self, rng: torch.Generator, target: Target[R]) -> ParticleCollection[R]:
        return self._local().init(self._stream(rng), target)

    def lml(self, collection: ParticleCollection[R]) -> torch.Tensor:
        return sharded_lml(collection.get_log_weights(), self.mesh, self.axis)

    def ess(self, collection: ParticleCollection[R]) -> torch.Tensor:
        return sharded_ess(collection.get_log_weights(), self.mesh, self.axis)

    def extend(
        self,
        rng: torch.Generator,
        collection: ParticleCollection[R],
        constraint: ChoiceMap,
        argdiffs: tuple | None = None,
    ) -> ParticleCollection[R]:
        return self._local().extend(self._stream(rng), collection, constraint, argdiffs)

    def rejuvenate(self, rng: torch.Generator, collection: ParticleCollection[R], request) -> ParticleCollection[R]:
        return self._local().rejuvenate(self._stream(rng), collection, request)

    def _resample(self, rng: torch.Generator, collection: ParticleCollection[R], lse=None) -> ParticleCollection[R]:
        if self._n() == 1:
            # One rank: the dense resampler, with the dense gate's lse.
            return collection.resample(rng, self.resampling, lse)
        anc, lse_all = _gathered_ancestors(rng, collection.get_log_weights(), self.mesh, self.axis)
        particles = exchange_rows(collection.get_particles(), anc, self.mesh, self.axis)
        avg = (lse_all - math.log(self.n_particles)).expand(anc.shape[0]).contiguous()
        return ParticleCollection(particles, avg, collection.is_valid)

    def resample(self, rng: torch.Generator, collection: ParticleCollection[R]) -> ParticleCollection[R]:
        """Systematic resampling across the ranks; every weight becomes the
        mean weight, `logsumexp(all K weights) - log K`."""
        return self._resample(rng, collection)

    def maybe_resample(self, rng: torch.Generator, collection: ParticleCollection[R]) -> ParticleCollection[R]:
        """Resample if the all-reduced ESS is below `ess_threshold *
        n_particles` (a host read of a value every rank holds the same)."""
        lse, ess = logsumexp_ess(collection.get_log_weights())
        _, s = _shard_sums(lse, ess, self.mesh, self.axis)
        if _ess_from(s) < self.ess_threshold * self.n_particles:
            return self._resample(rng, collection, lse)
        return collection


__all__ = [
    "ShardedSMC",
    "exchange_rows",
    "gather_rows",
    "sharded_ess",
    "sharded_lml",
    "sharded_systematic_ancestors",
    "sharded_systematic_exchange",
    "systematic_slot_ancestors",
]
