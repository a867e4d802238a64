"""The stitched dense references of the sharded drivers, and the rank
bodies that certify them.

A sharded driver on n ranks must equal, block by block, the dense driver
run on each rank's block with that rank's stream (`fork(rng, n)[r]`),
with the cross-rank steps (the weight reductions, the resampling, the
tempering exchange, the Stein interaction) done on the stitched blocks by
the dense port. That single-process run is the stitched dense reference:
at n = 1 it is the dense driver itself fed `fork(rng, 1)[0]`. The
references here (`stitch`, `blocks_of`, `StitchedSMC`, `StitchedGrid`,
`stitched_pt`, `stitched_svgd`, `stitched_warmup`, `stitched_chees`,
`stitched_nuts`) use the dense port only, no collective. A warmup's
cross-chain statistics are the blocks' float64 partial sums added in rank
order (`adaptation.ChainShards` without a mesh), where a rank all-reduces
them.

A data-sharded model (`parallel/data.py`) has no stitched reference: its
ranks move the same replicated chains, so it is held against the dense
model on the whole data from the same generator.

The rank bodies (`*_rank_body`) run on every rank of a
`parallel/launch.py` launch and return plain data (numpy arrays, floats,
the collectives' record) for the caller to hold against the references:
the CPU tests, `entry.dryrun_multichip` and `chip_smoke.py` run them, and
a spawned rank imports nothing else. Each test module spawns one pool and
runs one body that covers all its cases.
"""

import dataclasses
import hashlib
import math
import sys

import numpy as np
import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import batched_mask, take_rows
from genjax_tpu_torch.core.gfi import Trace
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.distributions.library import flip, mv_normal_diag, normal
from genjax_tpu_torch.inference.adaptation import ChainShards, adapt_blocks, mh_step
from genjax_tpu_torch.inference.chees import chees_blocks
from genjax_tpu_torch.inference.mcmc import run_chains, share_chain_args
from genjax_tpu_torch.inference.parallel_tempering import ParallelTempering, PTResult, deo_exchange
from genjax_tpu_torch.inference.requests.nuts import nuts_step
from genjax_tpu_torch.inference.smc import (
    ParticleCollection,
    SMCDriver,
    cum_counts_to_ancestors,
    systematic_cum_counts,
)
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.inference.svgd import _grad_batch, _prepare_particles, stein_direction
from genjax_tpu_torch.lang.static import gen
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess
from genjax_tpu_torch.parallel import collectives as C

EXACT_LML = -0.25 - 0.5 * math.log(2 * math.pi * 2.0)  # log N(1; 0, sqrt 2): y = 1 under `conjugate`
POST_MEAN = 0.5
LML_SD = 1.87  # sd of one importance weight's log over the prior, in units of 1/sqrt(K) (JAX's dryrun)


@gen
def conjugate():
    x = normal(0.0, 1.0) @ "x"
    return normal(x, 1.0) @ "y"


@gen
def wide(X):
    """A per-particle payload of three dtypes (float rows, a bool, the
    score) beside a shared argument `X`: the exchange's test model."""
    w = mv_normal_diag(X.new_zeros(X.shape[-1]), X.new_ones(X.shape[-1])) @ "w"
    _ = flip(0.3) @ "b"
    _ = normal((w * X[0]).sum(-1), 1.0) @ "y"


@gen
def regression(X):
    w = mv_normal_diag(X.new_zeros(X.shape[-1]), X.new_ones(X.shape[-1])) @ "w"
    _ = normal(w @ X.mT, 1.0) @ "ys"


#############################
# Stitching dense blocks    #
#############################


def stitch(blocks: list):
    """One collection (or trace, or choice map) from rank blocks: the
    per-particle leaves concatenated in rank order, the shared leaves
    block 0's."""
    if isinstance(blocks[0], ParticleCollection):
        return ParticleCollection(
            stitch([b.get_particles() for b in blocks]),
            torch.cat([b.get_log_weights() for b in blocks]),
            blocks[0].is_valid,
        )
    leaves, spec, bits = batched_mask(blocks[0])
    cols = [pytree.tree_leaves(b) for b in blocks]
    out = [torch.cat([c[i] for c in cols]) if b else v for i, (v, b) in enumerate(zip(leaves, bits))]
    return pytree.tree_unflatten(out, spec)


def rows(tree, lo: int, hi: int):
    """Rows `[lo, hi)` of every per-particle leaf (of a collection's
    particles and weights too)."""
    if isinstance(tree, ParticleCollection):
        return ParticleCollection(rows(tree.get_particles(), lo, hi), tree.get_log_weights()[lo:hi], tree.is_valid)
    leaves, spec, bits = batched_mask(tree)
    return pytree.tree_unflatten([v[lo:hi] if b else v for v, b in zip(leaves, bits)], spec)


def blocks_of(tree, n: int) -> list:
    """The n rank blocks of a stitched collection or trace."""
    k = (tree.get_log_weights() if isinstance(tree, ParticleCollection) else _batched(tree)[0]).shape[0] // n
    return [rows(tree, r * k, (r + 1) * k) for r in range(n)]


def _batched(tree) -> list:
    leaves, _, bits = batched_mask(tree)
    return [v for v, b in zip(leaves, bits) if b]


def leaves_np(tree) -> list:
    """Every tensor leaf of `tree` as a numpy array (for the caller of a
    rank body)."""
    return [v.detach().cpu().numpy() for v in pytree.tree_leaves(tree) if isinstance(v, torch.Tensor)]


@dataclasses.dataclass(frozen=True)
class StitchedSMC:
    """`ShardedSMC` on `n_ranks` ranks, run in one process by the dense
    port: a state is the list of the ranks' blocks."""

    n_particles: int
    n_ranks: int
    ess_threshold: float = 0.5

    def _dense(self) -> SMCDriver:
        return SMCDriver(self.n_particles // self.n_ranks, ess_threshold=self.ess_threshold)

    def init(self, rng: torch.Generator, target: Target) -> list:
        return [self._dense().init(g, target) for g in fork(rng, self.n_ranks)]

    def extend(self, rng: torch.Generator, blocks: list, constraint: ChoiceMap) -> list:
        return [self._dense().extend(g, b, constraint) for g, b in zip(fork(rng, self.n_ranks), blocks)]

    def rejuvenate(self, rng: torch.Generator, blocks: list, request) -> list:
        return [self._dense().rejuvenate(g, b, request) for g, b in zip(fork(rng, self.n_ranks), blocks)]

    def lml(self, blocks: list) -> torch.Tensor:
        return stitch(blocks).get_log_marginal_likelihood_estimate()

    def resample(self, rng: torch.Generator, blocks: list, lse=None) -> list:
        """The dense systematic resampler on the stitched collection; off
        one rank, with `logsumexp` of all the weights (as the sharded
        resampler computes it from the gathered weights)."""
        col = stitch(blocks)
        if self.n_ranks > 1 or lse is None:
            lse = logsumexp(col.get_log_weights())
        return blocks_of(col.resample(rng, "systematic", lse), self.n_ranks)

    def maybe_resample(self, rng: torch.Generator, blocks: list) -> list:
        lse, ess = logsumexp_ess(stitch(blocks).get_log_weights())
        if ess < self.ess_threshold * self.n_particles:
            return self.resample(rng, blocks, lse)
        return blocks


def systematic_rows(u0, log_weights: torch.Tensor, lse=None) -> torch.Tensor:
    """The dense port's systematic ancestors of all K slots for the
    uniform `u0`."""
    n = log_weights.shape[0]
    return cum_counts_to_ancestors(systematic_cum_counts(u0, log_weights, n, lse), n)


@dataclasses.dataclass(frozen=True)
class StitchedGrid:
    """`GridSMC` on an `n_c x n_p` mesh, run in one process by the dense
    port. A state maps each rank `(c, p)` to its block: a collection of
    `C_l x K_l` cells, chain-major, with `(C_l, K_l)` weights."""

    n_chains: int
    n_particles: int
    n_c: int
    n_p: int
    ess_threshold: float = 0.5

    @property
    def c_l(self) -> int:
        return self.n_chains // self.n_c

    @property
    def k_l(self) -> int:
        return self.n_particles // self.n_p

    def _dense(self) -> SMCDriver:
        return SMCDriver(self.c_l * self.k_l, ess_threshold=self.ess_threshold)

    def _each(self, rng: torch.Generator, blocks: dict, fn) -> dict:
        gens = fork(rng, self.n_c * self.n_p)
        out = {}
        for (c, p), b in blocks.items():
            flat = ParticleCollection(b.get_particles(), b.get_log_weights().reshape(-1), b.is_valid)
            new = fn(gens[c * self.n_p + p], flat)
            out[(c, p)] = ParticleCollection(new.get_particles(), new.get_log_weights().reshape(self.c_l, self.k_l),
                                             new.is_valid)
        return out

    def init(self, rng: torch.Generator, target: Target) -> dict:
        gens = fork(rng, self.n_c * self.n_p)
        out = {}
        for c in range(self.n_c):
            for p in range(self.n_p):
                col = self._dense().init(gens[c * self.n_p + p], target)
                out[(c, p)] = ParticleCollection(col.get_particles(), col.get_log_weights().reshape(self.c_l, self.k_l))
        return out

    def extend(self, rng, blocks, constraint):
        return self._each(rng, blocks, lambda g, b: self._dense().extend(g, b, constraint))

    def rejuvenate(self, rng, blocks, request):
        return self._each(rng, blocks, lambda g, b: self._dense().rejuvenate(g, b, request))

    def chain(self, blocks: dict, c: int, j: int) -> ParticleCollection:
        """Chain j of chain-rank c, its K particles stitched over the
        particle ranks."""
        return stitch([rows(self._cells(blocks[(c, p)]), j * self.k_l, (j + 1) * self.k_l) for p in range(self.n_p)])

    @staticmethod
    def _cells(b: ParticleCollection) -> ParticleCollection:
        return ParticleCollection(b.get_particles(), b.get_log_weights().reshape(-1), b.is_valid)

    def per_chain_lml(self, blocks: dict) -> torch.Tensor:
        return torch.stack([
            self.chain(blocks, c, j).get_log_marginal_likelihood_estimate()
            for c in range(self.n_c) for j in range(self.c_l)
        ])

    def resample(self, u0: torch.Tensor, blocks: dict) -> dict:
        """Each chain resampled with its uniform `u0[chain]` by the dense
        port."""
        new = {}
        for c in range(self.n_c):
            chains = []
            for j in range(self.c_l):
                i = c * self.c_l + j
                col = self.chain(blocks, c, j)
                lse = logsumexp(col.get_log_weights())
                anc = systematic_rows(u0[i], col.get_log_weights(), lse)
                avg = (lse - math.log(self.n_particles)).expand(self.n_particles).contiguous()
                chains.append(ParticleCollection(take_rows(col.get_particles(), anc), avg, col.is_valid))
            for p in range(self.n_p):
                cells = stitch([rows(ch, p * self.k_l, (p + 1) * self.k_l) for ch in chains])
                lw = cells.get_log_weights().reshape(self.c_l, self.k_l)
                new[(c, p)] = ParticleCollection(cells.get_particles(), lw)
        return new


def stitched_pt(rng: torch.Generator, pt: ParallelTempering, target: Target, n_sweeps: int, n_ranks: int,
                collect=None, init_constraint=None) -> tuple[list, PTResult]:
    """`sharded_pt_run` on `n_ranks` ranks in one process: (the ranks'
    final traces, the result with the stitched log likelihoods)."""
    from genjax_tpu_torch.core.typing import per_particle, plain
    from genjax_tpu_torch.inference.tempered import tempered_mh

    n = pt.betas.shape[0]
    t_l = n // n_ranks
    obs_sel = target.constraint.get_selection()
    gens = fork(rng, n_ranks)
    state = [dataclasses.replace(pt, betas=pt.betas[r * t_l : (r + 1) * t_l]).init(g, target, init_constraint)
             for r, g in enumerate(gens)]
    betas = torch.as_tensor(pt.betas, dtype=state[0][1].dtype).to(state[0][1].device)
    perm = torch.arange(n, device=betas.device)
    collected, accs, attempts = [], [], []
    for sweep in range(n_sweeps):
        by_replica = torch.zeros_like(betas).scatter(0, perm, betas)
        new = []
        for r, (g, (traces, ll)) in enumerate(zip(gens, state)):
            local = per_particle(by_replica[r * t_l : (r + 1) * t_l])
            request = pt._request_for(local)
            for _ in range(pt.n_moves):
                traces, ll, _ = tempered_mh(g, traces, request, plain(local), obs_sel, ll)
            new.append((traces, ll))
        state = new
        ll_all = torch.cat([ll for _, ll in state])
        log_u = torch.log(torch.rand(n, generator=rng, device=rng.device))
        perm, acc, is_left = deo_exchange(perm, ll_all, betas, sweep % 2, log_u)
        if collect is not None:
            stats = torch.cat([collect(t) for t, _ in state])
            collected.append(stats.index_select(0, perm[:1]).squeeze(0))
        accs.append(acc[:-1])
        attempts.append(is_left[:-1])
    swap_rates = torch.stack(accs).sum(0) / torch.clamp(torch.stack(attempts).sum(0), min=1)
    out = torch.stack(collected) if collected else None
    return [t for t, _ in state], PTResult(None, torch.cat([ll for _, ll in state]), perm, out, swap_rates)


def stitched_svgd(rng: torch.Generator, model, args, observations, selection, n_particles: int, n_steps: int,
                  n_ranks: int, step_size: float, bandwidth: float) -> torch.Tensor:
    """The particles of `sharded_svgd` on `n_ranks` ranks with an explicit
    bandwidth, by the dense port: each rank's block initialized on its
    stream, the stitched set moved by the dense `stein_direction`."""
    per = n_particles // n_ranks
    gens = fork(rng, n_ranks)
    prepared = [_prepare_particles(g, model, args, observations, selection, per) for g in gens]
    grads = [_grad_batch(selection, tr, args, unravel) for tr, _, unravel in prepared]
    x = torch.cat([x0 for _, x0, _ in prepared])
    for _ in range(n_steps):
        g = torch.cat([f(x[r * per : (r + 1) * per]) for r, f in enumerate(grads)])
        phi, _ = stein_direction(x, g, bandwidth)
        x = x + step_size * phi
    return x


def stitched_warmup(rng: torch.Generator, blocks: list, selection, n_steps: int, *, algorithm: str = "hmc",
                    L: int = 10, eps0: float = 0.1, target_accept: float | None = None, adapt_mass: bool = True,
                    jitter: float = 0.2):
    """`warmup_chains(..., mesh=)` on `len(blocks)` ranks in one process:
    (the ranks' warmed blocks, the result)."""
    if target_accept is None:
        target_accept = 0.8 if algorithm == "hmc" else 0.574
    shards = ChainShards(sum(b.particle_count() for b in blocks))
    return adapt_blocks(fork(rng, len(blocks)), blocks, shards, selection, n_steps,
                        mh_step(algorithm, selection, L, jitter), eps0, target_accept, adapt_mass)


def stitched_chees(rng: torch.Generator, blocks: list, selection, n_steps: int, **kw):
    """`chees_warmup(..., mesh=)` on `len(blocks)` ranks in one process."""
    shards = ChainShards(sum(b.particle_count() for b in blocks))
    return chees_blocks(rng, fork(rng, len(blocks)), blocks, shards, selection, n_steps, **kw)


def stitched_nuts(rng: torch.Generator, blocks: list, selection, n_steps: int, *, max_depth: int = 6,
                  eps0: float = 0.1, target_accept: float = 0.8, adapt_mass: bool = True):
    """`nuts_warmup(..., mesh=)` on `len(blocks)` ranks in one process."""
    shards = ChainShards(sum(b.particle_count() for b in blocks))
    return adapt_blocks(fork(rng, len(blocks)), blocks, shards, selection, n_steps, nuts_step(selection, max_depth),
                        eps0, target_accept, adapt_mass)


def warmup_numbers(result) -> dict:
    """A warmup result's eps, accept rate, trajectory length (ChEES) and
    inverse mass leaves, as numpy."""
    out = {"eps": result.eps.cpu().numpy(), "accept_rate": result.accept_rate.cpu().numpy(),
           "inv_mass": leaves_np(result.inv_mass)}
    if hasattr(result, "trajectory_length"):
        out["T"] = result.trajectory_length.cpu().numpy()
    return out


def warmup_gap(got: dict, ref: dict) -> float:
    """The largest relative gap between two `warmup_numbers`: eps, T and
    every inverse-mass entry (0 where they are equal bit for bit)."""
    pairs = [(got["eps"], ref["eps"])] + list(zip(got["inv_mass"], ref["inv_mass"]))
    if "T" in ref:
        pairs.append((got["T"], ref["T"]))
    return max(float(np.max(np.abs(np.asarray(a, np.float64) - b) / np.abs(np.asarray(b, np.float64)))) for a, b in pairs)


def warmup_equal(got: dict, ref: dict) -> bool:
    keys = ("eps", "T") if "T" in ref else ("eps",)
    return all(np.array_equal(got[k], ref[k]) for k in keys) and all(
        np.array_equal(a, b) for a, b in zip(got["inv_mass"], ref["inv_mass"]))


#######################
# Rank bodies         #
#######################


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def smc_inputs(seed: int, k: int) -> dict:
    """The numpy inputs of `smc_rank_body`, made the same in every process
    from `seed`: healthy log weights, the same with block 1 (of 4) all
    `-inf`, all `-inf`, and weights whose mass sits on particle 0 (which
    forces the far exchange)."""
    rng = np.random.default_rng(seed)
    lw = (2.0 * rng.standard_normal(k)).astype(np.float32)
    dead = lw.copy()
    dead[k // 4 : k // 2] = -np.inf
    far = np.full(k, -30.0, np.float32)
    far[0] = 0.0
    return {"lw": lw, "dead": dead, "all_dead": np.full(k, -np.inf, np.float32), "far": far}


def smc_rank_body(rank: int, world: int, seed: int, k: int, device: str = "cpu") -> dict:
    """The ShardedSMC-layer cases of `tests/test_torch_parallel_smc.py`:
    the reductions, the ancestors, the near and the far exchange, three
    rounds of `ShardedSMC`, the MH chains, and the collectives' record of
    each."""
    from genjax_tpu_torch.core.choice_map import ChoiceMap as CM
    from genjax_tpu_torch.inference.requests import MALA
    from genjax_tpu_torch.parallel import (
        ShardedSMC,
        particle_mesh,
        shard_leading_axis,
        sharded_ess,
        sharded_lml,
        sharded_mh_chains,
        sharded_systematic_ancestors,
    )
    from genjax_tpu_torch.parallel.smc import sharded_systematic_exchange

    mesh = particle_mesh(device_type=device)
    per = k // world
    lo = rank * per
    inputs = {name: torch.as_tensor(v[lo : lo + per]).to(device) for name, v in smc_inputs(seed, k).items()}
    out: dict = {}

    # A shared argument with K rows stays whole; the per-particle leaves,
    # and a bare (K,) tensor, split; a 0-d tensor stays whole.
    X_k = torch.as_tensor(np.random.default_rng(seed).standard_normal((k, 3)).astype(np.float32)).to(device)
    full, _ = Target(wide, (X_k,), CM.kw(y=0.5)).importance(_gen(seed + 9, device), CM.empty(), n=k)
    scalar = torch.tensor(3.0, device=device)
    local, lw_rows, scalar_kept = shard_leading_axis((full, torch.arange(k, device=device), scalar), mesh)
    out["shard"] = {"leaves": leaves_np(local), "shared_kept": local.get_args()[0] is X_k,
                    "rows": lw_rows.cpu().numpy(), "scalar_kept": scalar_kept is scalar}

    C.reset_stats()
    for name in ("lw", "dead", "all_dead"):
        out[f"lml_{name}"] = float(sharded_lml(inputs[name], mesh))
        out[f"ess_{name}"] = float(sharded_ess(inputs[name], mesh))
    out["stats_reductions"] = C.stats()

    out["anc"] = sharded_systematic_ancestors(_gen(seed + 1, device), inputs["lw"], mesh).cpu().numpy()

    X = torch.as_tensor(np.random.default_rng(seed).standard_normal((per, 3)).astype(np.float32)).to(device)
    block, _ = Target(wide, (X,), CM.kw(y=0.5)).importance(fork(_gen(seed + 2, device), world)[rank], CM.empty(), n=per)
    for case, weights, u_seed in (("near", "lw", seed + 3), ("far", "far", seed + 4)):
        C.reset_stats()
        moved = sharded_systematic_exchange(_gen(u_seed, device), inputs[weights], block, mesh)
        out[f"exchange_{case}"] = leaves_np(moved)
        out[f"exchange_{case}_shared_kept"] = moved.get_args()[0] is X
        out[f"stats_exchange_{case}"] = C.stats()

    smc = ShardedSMC(n_particles=k, mesh=mesh, ess_threshold=2.0)
    rng = _gen(seed + 5, device)
    rounds = []
    for _ in range(3):
        col = smc.init(rng, Target(conjugate, (), CM.empty()))
        C.reset_stats()
        col = smc.extend(rng, col, CM.kw(y=1.0))
        extend_stats = C.stats()
        lml, ess = float(smc.lml(col)), float(smc.ess(col))
        weights = col.get_log_weights().cpu().numpy()
        C.reset_stats()
        col = smc.maybe_resample(rng, col)
        resample_stats = C.stats()
        C.reset_stats()
        col = smc.rejuvenate(rng, col, Regenerate(Selection.at["x"]))
        rounds.append({"lml": lml, "ess": ess, "weights": weights, "x": leaves_np(col.get_particles()),
                       "after": col.get_log_weights().cpu().numpy(), "stats_extend": extend_stats,
                       "stats_resample": resample_stats, "stats_rejuvenate": C.stats()})
    out["rounds"] = rounds

    cmesh = particle_mesh(axis_name="chains", device_type=device)
    Xc = torch.as_tensor(np.random.default_rng(seed + 6).standard_normal((32, 3)).astype(np.float32)).to(device)
    ys = torch.zeros(32, device=device)
    traces, _ = regression.importance(fork(_gen(seed + 7, device), world)[rank], CM.kw(ys=ys), (Xc,), n=16)
    traces = share_chain_args(traces, (Xc,))
    C.reset_stats()
    finals, accs = sharded_mh_chains(_gen(seed + 8, device), traces, MALA(Selection.at["w"], 1e-2), 5, cmesh)
    out["chains"] = {"w": finals.get_choices()["w"].cpu().numpy(), "accs": accs.cpu().numpy(),
                     "score": finals.get_score().cpu().numpy(), "shared_kept": finals.get_args()[0] is Xc,
                     "stats": C.stats()}
    out["foreign_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "genjax_tpu"))
    return out


def grid_inputs(seed: int, n_chains: int, k: int) -> np.ndarray:
    """Log weights `(C, K)` for the per-chain reductions."""
    return (1.5 * np.random.default_rng(seed).standard_normal((n_chains, k))).astype(np.float32)


def grid_rank_body(rank: int, world: int, seed: int, device: str = "cpu") -> dict:
    """The GridSMC and multihost cases of
    `tests/test_torch_parallel_grid_multihost.py` on a 2 x 2 mesh, run
    with `LOCAL_WORLD_SIZE=2` (two "nodes" of two ranks)."""
    from genjax_tpu_torch.core.choice_map import ChoiceMap as CM
    from genjax_tpu_torch.parallel import (
        GridSMC,
        global_from_process_local,
        grid_mesh,
        hybrid_mesh,
        initialize_multihost,
        island_smc,
        pooled_lml,
        process_local_rows,
    )

    out: dict = {"initialized": initialize_multihost()}
    mesh = grid_mesh(2, 2, device_type=device)
    c, p = mesh.rank("chains"), mesh.rank("particles")
    n_chains, k = 4, 512
    grid = GridSMC(n_chains=n_chains, n_particles=k, mesh=mesh)
    c_l, k_l = n_chains // 2, k // 2

    lw = torch.as_tensor(grid_inputs(seed, n_chains, k)[c * c_l : (c + 1) * c_l, p * k_l : (p + 1) * k_l]).to(device)
    C.reset_stats()
    probe = ParticleCollection(None, lw)
    out["lml"], out["ess"] = grid.per_chain_lml(probe).cpu().numpy(), grid.per_chain_ess(probe).cpu().numpy()
    out["stats_reductions"] = C.stats()

    target = Target(conjugate, (), CM.kw(y=1.0))
    rng = _gen(seed + 1, device)
    col = grid.init(rng, target)
    out["round_lml"] = grid.per_chain_lml(col).cpu().numpy()
    C.reset_stats()
    col = grid.resample(rng, col)
    out["stats_resample"] = C.stats()
    col = grid.rejuvenate(rng, col, Regenerate(Selection.at["x"]))
    out["round"] = {"x": leaves_np(col.get_particles()), "lw": col.get_log_weights().cpu().numpy()}

    # One chain degenerate: only it resamples.
    col = grid.init(rng, target)
    lw0 = col.get_log_weights()
    degenerate = torch.full_like(lw0, -1e9)
    degenerate[:, 0] = 0.0 if p == 0 else -1e9
    if c == 0:
        lw0 = torch.cat([lw0[:1], degenerate[1:]])
    col = ParticleCollection(col.get_particles(), lw0, col.is_valid)
    after = grid.maybe_resample(rng, col)
    out["degenerate"] = {
        "x_before": col.get_particles().get_choices()["x"].reshape(c_l, k_l).cpu().numpy(),
        "x_after": after.get_particles().get_choices()["x"].reshape(c_l, k_l).cpu().numpy(),
        "lw_before": lw0.cpu().numpy(), "lw_after": after.get_log_weights().cpu().numpy(),
    }

    # A shared design matrix with as many rows as the particles of a chain.
    X = torch.as_tensor(np.random.default_rng(seed + 2).standard_normal((16, 3)).astype(np.float32)).to(device)
    ys = torch.zeros(16, device=device)
    small = GridSMC(n_chains=4, n_particles=16, mesh=mesh)
    col = small.init(rng, Target(regression, (X,), CM.kw(ys=ys)))
    kept = col.get_particles().get_args()[0] is X
    col = small.maybe_resample(rng, small.resample(rng, col))
    col = small.rejuvenate(rng, col, Regenerate(Selection.at["w"]))
    ws = col.get_particles().get_choices()["w"]
    out["shared"] = {"kept_after_init": kept, "kept_after_moves": col.get_particles().get_args()[0] is X,
                     "shape": tuple(col.get_particles().get_args()[0].shape), "w": ws.cpu().numpy(),
                     "score": col.get_particles().get_score().cpu().numpy()}

    # The multi-node hybrid mesh (LOCAL_WORLD_SIZE=2: two nodes of two ranks).
    out["hybrid_default"] = hybrid_mesh(device_type=device).shape
    out["hybrid_4x1"] = hybrid_mesh(island_devices=4, device_type=device).shape
    errors = {}
    for name, kw in (("fewer_islands", dict(island_devices=1)), ("not_dividing", dict(island_devices=6)),
                     ("inconsistent", dict(island_devices=2, particle_devices=1))):
        try:
            hybrid_mesh(device_type=device, **kw)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["hybrid_errors"] = errors

    hmesh = hybrid_mesh(island_devices=2, particle_devices=2, device_type=device)
    islands = island_smc(n_islands=2, n_particles=2048, mesh=hmesh)
    icol = islands.init(_gen(seed + 3, device), target)
    C.reset_stats()
    lmls = islands.per_chain_lml(icol)
    out["islands"] = {"lml": lmls.cpu().numpy(), "pooled": float(pooled_lml(lmls, hmesh, "islands")),
                      "stats": C.stats()}

    local = (torch.arange(8, dtype=torch.float32) + 100.0 * hmesh.rank("islands")).reshape(4, 2).to(device)
    dt = global_from_process_local({"w": local}, hmesh, ("islands", None))["w"]
    out["dtensor"] = {"shape": tuple(dt.shape), "back": process_local_rows(dt), "local": local.cpu().numpy()}
    return out


@gen
def wide_pt(z):
    w = normal(z, 1.0) @ "w"
    _ = normal(w.sum(-1), 1.0) @ "y"


@gen
def conj_mu():
    mu = normal(0.0, 1.0) @ "mu"
    _ = normal(mu, 1.0) @ "y"


@gen
def vector_model(y):
    w = normal(torch.zeros_like(y), 1.0) @ "w"
    _ = normal(w, 0.5) @ "y"
    return w


SVGD_Y = (-1.0, -1.0 / 3.0, 1.0 / 3.0, 1.0)


def stein_inputs(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Positions and gradients `(64, 4)` for the Stein direction."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((64, 4)).astype(np.float32), rng.standard_normal((64, 4)).astype(np.float32)


def pt_ladder(device) -> ParallelTempering:
    from genjax_tpu_torch.inference.requests import GaussianDrift

    return ParallelTempering(betas=torch.exp(-0.35 * torch.arange(8, dtype=torch.float32, device=device)),
                             request=GaussianDrift(Selection.at["w"], 0.4), n_moves=2)


def pt_svgd_rank_body(rank: int, world: int, seed: int, device: str = "cpu") -> dict:
    """The cases of `tests/test_torch_parallel_pt_svgd.py`."""
    from genjax_tpu_torch.core.choice_map import ChoiceMap as CM
    from genjax_tpu_torch.inference.requests import GaussianDrift
    from genjax_tpu_torch.parallel import particle_mesh, sharded_pt_run, sharded_stein_direction, sharded_svgd

    out: dict = {}
    rmesh = particle_mesh(axis_name="replicas", device_type=device)
    target = Target(wide_pt, (torch.zeros(8, device=device),), CM.kw(y=1.0))
    C.reset_stats()
    res = sharded_pt_run(_gen(seed, device), pt_ladder(device), target, 40, rmesh,
                         collect=lambda t: t.get_choices()["w"].sum(-1))
    out["pt"] = {"perm": res.perm.cpu().numpy(), "collected": res.collected.cpu().numpy(),
                 "logliks": res.logliks.cpu().numpy(), "swap_rates": res.swap_rates.cpu().numpy(),
                 "w": res.traces.get_choices()["w"].cpu().numpy(), "stats": C.stats()}

    conj = ParallelTempering(betas=torch.tensor([1.0, 0.6, 0.3, 0.1] * 2, device=device),
                             request=GaussianDrift(Selection.at["mu"], 0.8))
    res = sharded_pt_run(_gen(seed + 1, device), conj, Target(conj_mu, (), CM.kw(y=1.0)), 1000, rmesh,
                         collect=lambda t: t.get_choices()["mu"])
    out["pt_posterior"] = res.collected.cpu().numpy()
    try:
        sharded_pt_run(_gen(0, device), dataclasses.replace(conj, betas=conj.betas[:6]),
                       Target(conj_mu, (), CM.kw(y=1.0)), 4, rmesh)
        out["pt_uneven"] = None
    except ValueError as e:
        out["pt_uneven"] = str(e)

    pmesh = particle_mesh(device_type=device)
    x_np, g_np = stein_inputs(seed)
    per = x_np.shape[0] // world
    x_l, g_l = (torch.as_tensor(a[rank * per : (rank + 1) * per]).to(device) for a in (x_np, g_np))
    out["stein"] = {"h1": sharded_stein_direction(x_l, g_l, pmesh, "particles", x_np.shape[0], 1.0).cpu().numpy(),
                    "median": sharded_stein_direction(x_l, g_l, pmesh, "particles", x_np.shape[0]).cpu().numpy()}

    y = torch.tensor(SVGD_Y, device=device)
    C.reset_stats()
    traces, norms = sharded_svgd(_gen(seed + 2, device), vector_model, (y,), CM.kw(y=y), Selection.at["w"],
                                 n_particles=64, n_steps=50, mesh=pmesh, step_size=0.2, bandwidth=1.0)
    out["svgd"] = {"w": traces.get_choices()["w"].cpu().numpy(), "norms": norms.cpu().numpy(), "stats": C.stats()}
    traces, _ = sharded_svgd(_gen(seed + 3, device), vector_model, (y,), CM.kw(y=y), Selection.at["w"],
                             n_particles=256, n_steps=400, mesh=pmesh, step_size=0.2)
    out["svgd_median"] = traces.get_choices()["w"].cpu().numpy()
    try:
        sharded_svgd(_gen(0, device), vector_model, (y,), CM.kw(y=y), Selection.at["w"], n_particles=102,
                     n_steps=1, mesh=pmesh)
        out["svgd_indivisible"] = None
    except ValueError as e:
        out["svgd_indivisible"] = str(e)
    return out


@gen
def two_sites():
    a = normal(0.0, 0.1) @ "a"
    _ = mv_normal_diag(torch.zeros(3), 10.0 * torch.ones(3)) @ "b"
    return a


# The warmup cases of `tests/test_torch_parallel_warmup_data.py`: JAX's
# `tests/parallel/test_sharded_warmup.py` sizes, the statistical cases
# replicated from independent generators; `pairs`, one
# `chees_pairs_rank_body` pair per rank on eight schools.
WARMUP = dict(n_chains=64, n_steps=40, L=5, max_leapfrog=16, replicates=8, nuts_steps=12, nuts_depth=4,
              pairs=dict(n_chains=8, n_steps=10, max_leapfrog=16))
# The data-sharded cases: logistic regression at N data, D features, C chains.
DATA = dict(n=256, d=8, c=16, eps=0.02, L=5, steps=5)


def warmup_inputs(seed: int, n_chains: int) -> dict:
    """Chain rows for `cross_chain_inv_mass` (`two_sites`' a and b) and for
    the ChEES gradient (end points with a diverged chain of each kind)."""
    rng = np.random.default_rng(seed)
    c = n_chains
    q0 = {"v": rng.standard_normal((c, 2)).astype(np.float32), "x": rng.standard_normal(c).astype(np.float32)}
    q1 = {k: (v + 0.5 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in q0.items()}
    q1["x"][3], q1["v"][c // 2 + 1, 1] = np.inf, np.nan
    probs = rng.random(c).astype(np.float32)
    probs[3] = probs[c // 2 + 1] = 0.0
    return {"a": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "b": (10.0 * rng.standard_normal((c, 3))).astype(np.float32),
            "probs": probs, "q0": q0, "q1": q1,
            "p1": {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in q0.items()},
            "im": {"v": np.array([1.5, 0.3], np.float32), "x": np.float32(0.7)}, "traj_t": np.float32(1.7)}


def data_inputs(seed: int, n: int, d: int, c: int) -> dict:
    """Logistic-regression data `(X, ys)` and two weight batches `(C, D)`."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32)
    ys = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ w_true))).astype(np.int32)
    return {"X": X, "ys": ys, "w": (0.5 * rng.standard_normal((c, d))).astype(np.float32),
            "w2": (0.5 * rng.standard_normal((c, d))).astype(np.float32)}


def warmup_start(seed: int, n_chains: int, device) -> Trace:
    """The whole chain batch of a warmup case, drawn alike on every rank
    (each rank keeps its block)."""
    traces, _ = conj_mu.importance(_gen(seed, device), ChoiceMap.kw(y=1.0), (), n=n_chains)
    return traces


def eight_schools_start(seed: int, n_chains: int, device):
    """Eight-schools chains started as `run_eight_schools` starts them
    (log tau Uniform(-2, 2) per chain, the rest from the prior), and the
    selection of every latent."""
    from genjax_tpu_torch.core.typing import per_particle
    from genjax_tpu_torch.models.hierarchical import EIGHT_SCHOOLS_SIGMA, EIGHT_SCHOOLS_Y, eight_schools

    y, sigma = EIGHT_SCHOOLS_Y.to(device), EIGHT_SCHOOLS_SIGMA.to(device)
    init = _gen(seed, device)
    log_tau = per_particle(4.0 * torch.rand(n_chains, generator=init, device=device) - 2.0)
    start, _ = eight_schools.importance(init, ChoiceMap.kw(ys=y, log_tau=log_tau), (sigma,), n=n_chains)
    return start, ~ChoiceMap.kw(ys=y).get_selection()


def chees_pairs_rank_body(rank: int, world: int, seeds: list, n_chains: int, n_steps: int, max_leapfrog: int,
                          device: str = "cpu") -> list:
    """Independent pairs of `chees_warmup` runs on eight schools, the pairs
    of `seeds[rank::world]` on this rank. A pair starts from
    `eight_schools_start(seed)` and runs the warmup over a one-rank chain
    axis (each rank its own: a `(world, 1)` mesh) and the plain dense
    warmup, each on a generator seeded `seed + 1`. Per run: log eps, log T,
    the accept rate, every log inverse-mass entry, leapfrog steps per ChEES
    step and seconds."""
    import time

    from genjax_tpu_torch.inference.chees import chees_stats, chees_warmup
    from genjax_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((world, 1), ("replicates", "chains"), device_type=device)
    out = []
    for seed in seeds[rank::world]:
        start, sel = eight_schools_start(seed, n_chains, device)
        pair = {}
        for kind, m in (("sharded", mesh), ("dense", None)):
            leapfrogs, t0 = chees_stats["leapfrog_total"], time.perf_counter()
            _, res = chees_warmup(_gen(seed + 1, device), start, sel, n_steps=n_steps, max_leapfrog=max_leapfrog,
                                  mesh=m)
            pair[kind] = {"log eps": math.log(float(res.eps)), "log T": math.log(float(res.trajectory_length)),
                          "accept": float(res.accept_rate),
                          "log inv_mass": [float(v) for v in torch.cat(
                              [torch.log(x.double()).reshape(-1) for x in pytree.tree_leaves(res.inv_mass)])],
                          "leapfrogs": (chees_stats["leapfrog_total"] - leapfrogs) / n_steps,
                          "seconds": time.perf_counter() - t0}
        out.append(pair)
    return out


def warmup_data_rank_body(rank: int, world: int, seed: int, device: str = "cpu") -> dict:
    """The cases of `tests/test_torch_parallel_warmup_data.py`: the sharded
    cross-chain statistics, the sharded warmups (`WARMUP["replicates"]`
    independent ones each for `warmup_chains` and `chees_warmup`, one for
    `nuts_warmup`), and logistic regression with its data split over the
    ranks (assess and its gradient, importance, the edits, HMC), with the
    collectives' record of each; and one `chees_pairs_rank_body` pair per
    rank."""
    from genjax_tpu_torch import convert
    from genjax_tpu_torch.core.gfi import Update
    from genjax_tpu_torch.core.typing import per_particle
    from genjax_tpu_torch.inference.adaptation import cross_chain_inv_mass, warmup_chains
    from genjax_tpu_torch.inference.chees import chees_statistics, chees_warmup
    from genjax_tpu_torch.inference.requests import HMC
    from genjax_tpu_torch.inference.requests.nuts import nuts_warmup
    from genjax_tpu_torch.models.logreg import logistic_regression
    from genjax_tpu_torch.parallel import particle_mesh
    from genjax_tpu_torch.parallel.data import data_sharded

    cmesh = particle_mesh(axis_name="chains", device_type=device)
    out: dict = {}
    cfg = WARMUP
    n = cfg["n_chains"]
    per = n // world
    lo, hi = rank * per, (rank + 1) * per

    inp = warmup_inputs(seed, n)
    local = convert.chain_batch(two_sites, (), {"a": inp["a"][lo:hi], "b": inp["b"][lo:hi]}, device=device)
    C.reset_stats()
    im = cross_chain_inv_mass(local, Selection.at["a"] | Selection.at["b"], mesh=cmesh)
    out["inv_mass"] = {"a": im["a"].cpu().numpy(), "b": im["b"].cpu().numpy(), "stats": C.stats()}

    def t(x):
        return torch.as_tensor(x[lo:hi]).to(device)

    order = sorted(inp["q0"])
    collected = [(t(inp["probs"]), *([t(inp[k][name]) for name in order] for k in ("q0", "q1", "p1")))]
    shards = ChainShards(n, cmesh, "chains")
    out["grad_logT"] = {
        case: float(chees_statistics(shards, collected, mass, torch.tensor(inp["traj_t"], device=device))[0])
        for case, mass in (("unit", None), ("mass", [torch.tensor(inp["im"][k], device=device) for k in order]))
    }

    sel = Selection.at["mu"]
    runs = {"warmup": [], "chees": []}
    for r in range(cfg["replicates"]):
        block = blocks_of(warmup_start(seed + 100 + r, n, device), world)[rank]
        C.reset_stats()
        warmed, res = warmup_chains(_gen(seed + 200 + r, device), block, sel, n_steps=cfg["n_steps"], L=cfg["L"],
                                    mesh=cmesh)
        runs["warmup"].append({**warmup_numbers(res), "mu": warmed.get_choices()["mu"].cpu().numpy(),
                               "stats": C.stats()})
        C.reset_stats()
        warmed, res = chees_warmup(_gen(seed + 300 + r, device), block, sel, n_steps=cfg["n_steps"],
                                   max_leapfrog=cfg["max_leapfrog"], mesh=cmesh)
        runs["chees"].append({**warmup_numbers(res), "mu": warmed.get_choices()["mu"].cpu().numpy(),
                              "stats": C.stats()})
    out.update(runs)
    block = blocks_of(warmup_start(seed + 400, n, device), world)[rank]
    warmed, res = nuts_warmup(_gen(seed + 401, device), block, sel, n_steps=cfg["nuts_steps"],
                              max_depth=cfg["nuts_depth"], mesh=cmesh)
    out["nuts"] = {**warmup_numbers(res), "mu": warmed.get_choices()["mu"].cpu().numpy()}

    # Logistic regression with its data split over the ranks.
    d = DATA
    dmesh = particle_mesh(axis_name="data", device_type=device)
    data = data_inputs(seed, d["n"], d["d"], d["c"])
    rows = slice(rank * d["n"] // world, (rank + 1) * d["n"] // world)
    X, ys = (torch.as_tensor(data[k][rows]).to(device) for k in ("X", "ys"))
    model = data_sharded(logistic_regression, dmesh, ["ys"], data_args=(0,))
    w = torch.as_tensor(data["w"]).to(device).requires_grad_()
    C.reset_stats()
    score, _ = model.assess(ChoiceMap.kw(w=per_particle(w), ys=ys), (X,), n=d["c"])
    (grad,) = torch.autograd.grad(score.sum(), w)
    out["assess"] = {"score": score.detach().cpu().numpy(), "grad": grad.cpu().numpy(), "stats": C.stats()}
    w = w.detach()
    fixed = ChoiceMap.kw(w=per_particle(w), ys=ys)
    traces, lw = model.importance(_gen(seed + 5, device), fixed, (X,), n=d["c"])
    out["importance"] = {"lw": lw.cpu().numpy(), "score": traces.get_score().cpu().numpy()}
    traces = share_chain_args(traces, (X,))
    same = Diff.no_change(traces.get_args())
    new, uw, _, _ = Update(ChoiceMap.kw(w=per_particle(torch.as_tensor(data["w2"]).to(device)))).edit(
        _gen(seed + 6, device), traces, same)
    regen, rw, _, _ = Regenerate(Selection.at["w"]).edit(_gen(seed + 7, device), traces, same)
    out["edits"] = {"update_w": uw.cpu().numpy(), "update_score": new.get_score().cpu().numpy(),
                    "regenerate_w": rw.cpu().numpy(), "regenerate_score": regen.get_score().cpu().numpy(),
                    "regenerated": regen.get_choices()["w"].cpu().numpy()}
    sim = model.simulate(_gen(seed + 8, device), (X,), n=d["c"])
    again, _ = model.assess(sim.get_choices(), (X,), n=d["c"])
    out["simulate"] = {"score": sim.get_score().cpu().numpy(), "assess": again.cpu().numpy()}

    start, _ = model.importance(_gen(seed + 9, device), ChoiceMap.kw(ys=ys), (X,), n=d["c"])
    start = share_chain_args(start, (X,))
    C.reset_stats()
    finals, accs = run_chains(_gen(seed + 10, device), start, HMC(Selection.at["w"], d["eps"], L=d["L"]), d["steps"])
    out["hmc"] = {"score": finals.get_score().cpu().numpy(), "w": finals.get_choices()["w"].cpu().numpy(),
                  "accs": accs.cpu().numpy(), "stats": C.stats()}
    p = WARMUP["pairs"]
    out["chees_pairs"] = chees_pairs_rank_body(rank, world, [seed + 300 + i for i in range(world)], p["n_chains"],
                                               p["n_steps"], p["max_leapfrog"], device)
    out["foreign_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "genjax_tpu"))
    return out


def _equal(got, ref) -> bool:
    a, b = leaves_np(got), leaves_np(ref)
    return len(a) == len(b) and all(x.shape == y.shape and np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _state_digest(rng: torch.Generator) -> int:
    return int.from_bytes(hashlib.blake2b(rng.get_state().numpy().tobytes(), digest_size=7).digest(), "little")


def dryrun_rank_body(rank: int, world: int, device: str, k_per_rank: int = 32768) -> dict:
    """One full sharded inference step on every rank, each driver's
    numbers certified against the stitched dense run (computed on every
    rank, which checks its own block) or the conjugate oracle: ShardedSMC
    (init, LML, ESS, the gated resample, three rejuvenations) at
    `k_per_rank` particles per rank, its resample of degenerate weights and
    the all-gather fallback on its own, the MH chains, GridSMC and island
    SMC (on an even number of ranks), SVGD, tempered SMC and parallel
    tempering, then the warmups over the chain axis and data-sharded HMC
    (`warmup_section`). Returns the rank's numbers and the collectives'
    record of each section."""
    from genjax_tpu_torch.core.choice_map import ChoiceMap as CM
    from genjax_tpu_torch.inference.requests import GaussianDrift
    from genjax_tpu_torch.inference.tempered import TemperedSMC
    from genjax_tpu_torch.parallel import (
        GridSMC,
        ShardedSMC,
        grid_mesh,
        hybrid_mesh,
        island_smc,
        particle_mesh,
        pooled_lml,
        sharded_mh_chains,
        sharded_pt_run,
        sharded_svgd,
    )
    from genjax_tpu_torch.parallel.smc import gather_rows, sharded_systematic_ancestors

    out: dict = {"rank": rank, "world": world, "stats": {}}
    pmesh = particle_mesh(device_type=device)
    target = Target(conjugate, (), CM.kw(y=1.0))
    x_sel = Regenerate(Selection.at["x"])

    # Every rank must seed the replicated generator alike (rule of the layer).
    C.reset_stats()
    mine = torch.tensor([_state_digest(_gen(1, device))], dtype=torch.int64, device=device)
    _check(bool((C.broadcast(mine.clone(), pmesh, "particles") == mine).all()), "the replicated generators differ")

    # ShardedSMC against the stitched dense run and the oracle.
    k = k_per_rank * world
    smc, ref = ShardedSMC(k, pmesh, ess_threshold=2.0), StitchedSMC(k, world, 2.0)
    rng, rng_ref = _gen(1, device), _gen(1, device)
    C.reset_stats()
    col, blocks = smc.init(rng, target), ref.init(rng_ref, target)
    lml, ess = smc.lml(col), smc.ess(col)
    dense_lml = ref.lml(blocks)
    _check(abs(float(lml) - float(dense_lml)) <= 1e-5 * max(1.0, abs(float(dense_lml))),
           f"sharded LML {float(lml)} against the stitched logsumexp {float(dense_lml)}")
    _check(abs(float(lml) - EXACT_LML) <= 6 * LML_SD / math.sqrt(k), f"sharded LML {float(lml)} against the oracle")
    col, blocks = smc.maybe_resample(rng, col), ref.maybe_resample(rng_ref, blocks)
    for _ in range(3):
        col, blocks = smc.rejuvenate(rng, col, x_sel), ref.rejuvenate(rng_ref, blocks, x_sel)
    _check(_equal(col, blocks[rank]), "ShardedSMC's round differs from the stitched dense run")
    xs = col.get_particles().get_choices()["x"]
    mean = float(C.all_reduce(xs.sum(), pmesh, "particles")) / k
    _check(abs(mean - POST_MEAN) <= 0.05, f"sharded SMC posterior mean {mean}")
    out.update(lml=float(lml), ess=float(ess), posterior_mean=mean)
    out["stats"]["smc"] = C.stats()

    # Degenerate weights: every slot copies particle 0 (rank 0's first).
    far = torch.full((k,), -30.0, device=device)
    far[0] = 0.0
    col_far = ParticleCollection(col.get_particles(), far[rank * k_per_rank : (rank + 1) * k_per_rank].clone())
    blocks_far = [ParticleCollection(b.get_particles(), far[r * k_per_rank : (r + 1) * k_per_rank].clone())
                  for r, b in enumerate(blocks)]
    C.reset_stats()
    res, res_ref = smc.resample(rng, col_far), ref.resample(rng_ref, blocks_far)
    _check(_equal(res, res_ref[rank]), "the resample of degenerate weights differs from the stitched dense run")
    out["stats"]["degenerate_resample"] = C.stats()
    if world > 1:
        C.reset_stats()
        anc = sharded_systematic_ancestors(_gen(9, device), col_far.get_log_weights(), pmesh)
        u0 = torch.rand((), generator=_gen(9, device), device=device)
        stitched = stitch([b.get_particles() for b in blocks_far])
        dense = take_rows(stitched, systematic_rows(u0, far))
        _check(_equal(gather_rows(col_far.get_particles(), anc, pmesh), blocks_of(dense, world)[rank]),
               "the all-gather fallback differs from the stitched dense rows")
        out["stats"]["far_fallback"] = C.stats()

    # MH chains: the dense driver on this rank's chains, from its fork.
    cmesh = particle_mesh(axis_name="chains", device_type=device)
    traces, _ = conjugate.importance(fork(_gen(2, device), world)[rank], CM.kw(y=1.0), (), n=4)
    C.reset_stats()
    finals, _ = sharded_mh_chains(_gen(3, device), traces, x_sel, 3, cmesh)
    dense, _ = run_chains(fork(_gen(3, device), world)[rank], traces, x_sel, 3)
    _check(_equal(finals, dense), "sharded MH chains differ from the dense run from the fork")
    out["stats"]["chains"] = C.stats()

    if world >= 2 and world % 2 == 0:
        mesh2 = grid_mesh(2, world // 2, device_type=device)
        n_c, k_g = 4, 256 * (world // 2)
        grid, gref = GridSMC(n_chains=n_c, n_particles=k_g, mesh=mesh2), StitchedGrid(n_c, k_g, 2, world // 2)
        rng, rng_ref = _gen(4, device), _gen(4, device)
        C.reset_stats()
        gcol, gblocks = grid.init(rng, target), gref.init(rng_ref, target)
        lmls, lmls_ref = grid.per_chain_lml(gcol), gref.per_chain_lml(gblocks)
        c, p = mesh2.rank("chains"), mesh2.rank("particles")
        mine_ref = lmls_ref[c * 2 : (c + 1) * 2]
        _check(bool(torch.allclose(lmls, mine_ref, rtol=0, atol=1e-5)), "GridSMC LMLs against the stitched run")
        tol = 6 * LML_SD / math.sqrt(k_g)
        _check(bool(((lmls - EXACT_LML).abs() <= tol).all()), f"GridSMC chain LMLs {lmls.tolist()} against the oracle")
        u0 = torch.rand(n_c, generator=_gen(5, device), device=device)
        gcol = grid.rejuvenate(rng, grid.resample(_gen(5, device), gcol), x_sel)
        gblocks = gref.rejuvenate(rng_ref, gref.resample(u0, gblocks), x_sel)
        _check(_equal(gcol, gblocks[(c, p)]), "GridSMC's round differs from the stitched dense run")
        out["grid_lml"] = lmls.tolist()
        out["stats"]["grid"] = C.stats()

        hmesh = hybrid_mesh(island_devices=2, particle_devices=world // 2, device_type=device)
        n_island = 512 * world
        islands = island_smc(n_islands=2, n_particles=n_island, mesh=hmesh)
        C.reset_stats()
        icol = islands.init(_gen(6, device), target)
        plml = float(pooled_lml(islands.per_chain_lml(icol), hmesh, "islands"))
        _check(abs(plml - EXACT_LML) <= 6 * LML_SD / math.sqrt(2 * n_island), f"island SMC pooled LML {plml}")
        out["pooled_lml"] = plml
        out["stats"]["islands"] = C.stats()

    # SVGD with an explicit bandwidth: the dense transport of the same particles.
    n_sv = 8 * world
    C.reset_stats()
    straces, _ = sharded_svgd(_gen(8, device), conjugate, (), CM.kw(y=1.0), Selection.at["x"], n_particles=n_sv,
                              n_steps=5, mesh=pmesh, bandwidth=1.0)
    x_ref = stitched_svgd(_gen(8, device), conjugate, (), CM.kw(y=1.0), Selection.at["x"], n_sv, 5, world, 0.1, 1.0)
    got = straces.get_choices()["x"]
    want = x_ref[rank * 8 : (rank + 1) * 8, 0]
    _check(bool((got - want).abs().max() <= 1e-5), "sharded SVGD differs from the dense transport")
    out["stats"]["svgd"] = C.stats()

    tsmc = TemperedSMC(n_particles=256 * world, betas=torch.linspace(0.0, 1.0, 4, device=device), request=x_sel)
    _, log_z = tsmc.run(_gen(10 + rank, device), target)
    _check(abs(float(log_z) - EXACT_LML) <= 0.3, f"tempered SMC log Z {float(log_z)}")

    rmesh = particle_mesh(axis_name="replicas", device_type=device)
    pt = ParallelTempering(betas=torch.exp(-0.4 * torch.arange(2 * world, dtype=torch.float32, device=device)),
                           request=GaussianDrift(Selection.at["x"], 0.5))
    collect = lambda t: t.get_choices()["x"]  # noqa: E731
    C.reset_stats()
    res = sharded_pt_run(_gen(11, device), pt, target, 5, rmesh, collect=collect)
    _, res_ref = stitched_pt(_gen(11, device), pt, target, 5, world, collect=collect)
    _check(bool(torch.equal(res.collected, res_ref.collected) and torch.equal(res.perm, res_ref.perm)),
           "sharded PT differs from the stitched dense run")
    out["stats"]["pt"] = C.stats()
    out.update(warmup_section(rank, world, device, cmesh))
    out["stats"].update(out.pop("section_stats"))
    return out


def warmup_section(rank: int, world: int, device: str, cmesh) -> dict:
    """The dry run's two sections after JAX's GSPMD ones: `warmup_chains`
    and `chees_warmup` over the chain axis (8 chains per rank, 10 steps, as
    JAX's dry run) against the stitched dense warmup (eps, T and every
    inverse-mass entry within 1e-5 relative, JAX's dry-run rule; whether
    they are equal bit for bit is returned), and HMC on logistic regression
    with its data split over the ranks against the dense model on the
    whole data from the same generator (scores and the final `w` within
    1e-5 relative; every collective an all-reduce on "data" of at most
    C D floats)."""
    from genjax_tpu_torch.inference.adaptation import warmup_chains
    from genjax_tpu_torch.inference.chees import chees_warmup
    from genjax_tpu_torch.inference.requests import HMC
    from genjax_tpu_torch.models.logreg import logistic_regression
    from genjax_tpu_torch.parallel import particle_mesh
    from genjax_tpu_torch.parallel.data import data_sharded

    out: dict = {"section_stats": {}, "bitwise": {}}
    sel = Selection.at["mu"]
    blocks = blocks_of(warmup_start(12, 8 * world, device), world)
    for name, run, stitched in (
        ("warmup", lambda b, m: warmup_chains(_gen(13, device), b, sel, n_steps=10, L=3, mesh=m),
         lambda: stitched_warmup(_gen(13, device), blocks, sel, 10, L=3)),
        ("chees", lambda b, m: chees_warmup(_gen(14, device), b, sel, n_steps=10, max_leapfrog=16, mesh=m),
         lambda: stitched_chees(_gen(14, device), blocks, sel, 10, max_leapfrog=16)),
    ):
        C.reset_stats()
        warmed, res = run(blocks[rank], cmesh)
        out["section_stats"][name] = C.stats()
        ref_blocks, ref = stitched()
        got, want = warmup_numbers(res), warmup_numbers(ref)
        gap = warmup_gap(got, want)
        _check(gap <= 1e-5, f"sharded {name} is {gap:.2e} (relative) off the stitched dense warmup")
        mu, mu_ref = warmed.get_choices()["mu"], ref_blocks[rank].get_choices()["mu"]
        _check(bool(((mu - mu_ref).abs() <= 1e-5 * mu_ref.abs().clamp(min=1.0)).all()),
               f"sharded {name}'s chains off the stitched ones")
        out["bitwise"][name] = warmup_equal(got, want) and bool(torch.equal(mu, mu_ref))
        out[f"{name}_eps"] = float(res.eps)

    d = dict(n=256, d=16, c=64, eps=0.02, L=5, steps=5)
    dmesh = particle_mesh(axis_name="data", device_type=device)
    data = data_inputs(15, d["n"], d["d"], d["c"])
    X_all, ys_all = (torch.as_tensor(data[k]).to(device) for k in ("X", "ys"))
    per = d["n"] // world
    X, ys = X_all[rank * per : (rank + 1) * per], ys_all[rank * per : (rank + 1) * per]
    model = data_sharded(logistic_regression, dmesh, ["ys"], data_args=(0,))
    start = share_chain_args(model.importance(_gen(16, device), ChoiceMap.kw(ys=ys), (X,), n=d["c"])[0], (X,))
    dense = logistic_regression.importance(_gen(16, device), ChoiceMap.kw(ys=ys_all), (X_all,), n=d["c"])[0]
    dense = share_chain_args(dense, (X_all,))
    req = HMC(Selection.at["w"], d["eps"], L=d["L"])
    C.reset_stats()
    finals, _ = run_chains(_gen(17, device), start, req, d["steps"])
    stats = C.stats()
    ref, _ = run_chains(_gen(17, device), dense, req, d["steps"])
    s, s_ref = finals.get_score(), ref.get_score()
    _check(bool(((s - s_ref).abs() <= 1e-5 * s_ref.abs()).all()), "data-sharded HMC scores off the dense run's")
    w, w_ref = finals.get_choices()["w"], ref.get_choices()["w"]
    _check(bool(((w - w_ref).abs() <= 1e-5 * w_ref.abs().clamp(min=1.0)).all()), "data-sharded HMC's w off the dense run's")
    kinds = {k: v for k, v in stats.get("data", {}).items() if v["calls"]}
    _check(set(stats) == {"data"} and set(kinds) == {"all_reduce"}
           and kinds["all_reduce"]["bytes"] <= kinds["all_reduce"]["calls"] * d["c"] * d["d"] * 4,
           f"data-sharded HMC's collectives are not chain-sized all-reduces on data: {stats}")
    out["section_stats"]["data_hmc"] = stats
    return out
