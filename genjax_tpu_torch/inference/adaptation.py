"""MCMC warmup adaptation: dual-averaging step sizes and cross-chain
mass matrices.

Counterpart of `genjax_tpu/inference/adaptation.py`: `DualAveragingState`,
`da_init`, `da_update`, `da_final`, `cross_chain_inv_mass`,
`WarmupResult` and `warmup_chains`.

- The step size follows Nesterov dual averaging on the cross-chain mean
  acceptance probability (Hoffman & Gelman 2014, 3.2). Its state is a
  handful of 0-d tensors on the chains' device, so a warmup step reads
  nothing on the host: the next step size is `exp(log_eps)` on the device.
- The diagonal mass matrix is the cross-chain variance of the selected
  values (with thousands of chains the spread across chains estimates the
  posterior variance in one step).

The schedule has three phases of fixed length (Python ints): an eps-only
burn-in on unit mass, a phase under the first mass estimate, and an eps
polish under the final one.

Over a sharded chain axis (`mesh=`, the counterpart of JAX's warmup jitted
with the chain axis sharded under GSPMD), each rank moves its own C/n
chains on its fork of the replicated generator (`fork(rng, n)[rank]`, as
`parallel/chains.py` does), and every cross-chain statistic is a global
one: the mean acceptance is an all-reduced float64 sum and count, the
variance two all-reduced float64 passes (the sum, then the squared
deviations from the global mean). Dual averaging then runs identically on
every rank. `ChainShards` forms those sums: all-reduced on a rank, added
in rank order in the stitched dense reference (`parallel/certify.py`),
which moves every rank's block in one process.
"""

import dataclasses
import math
from typing import Any, Callable

import torch

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.choice_map import Choice, Selection
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import Trace
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.core.typing import FloatArray, as_float, plain
from genjax_tpu_torch.inference.requests.hmc import HMC, MALA

__all__ = [
    "DualAveragingState",
    "WarmupResult",
    "cross_chain_inv_mass",
    "da_final",
    "da_init",
    "da_update",
    "warmup_chains",
]

# -- dual averaging ----------------------------------------------------------


@Pytree.dataclass
class DualAveragingState(Pytree):
    """The carried state of Nesterov dual averaging on `log eps`
    (Hoffman & Gelman 2014, 3.2): 0-d tensors."""

    log_eps: FloatArray
    log_eps_bar: FloatArray
    h_bar: FloatArray
    step: FloatArray
    mu: FloatArray


def da_init(eps0, device: torch.device | str | None = None) -> DualAveragingState:
    """Start dual averaging at `eps0`, shrinking toward `10 * eps0`. A
    number becomes a 0-d float32 tensor on `device` (the CPU by default);
    a tensor keeps its device."""
    if isinstance(eps0, torch.Tensor):
        log_eps0 = torch.log(plain(eps0).to(torch.float32))
    else:
        log_eps0 = torch.full((), math.log(float(eps0)), dtype=torch.float32, device=device)
    zero = torch.zeros_like(log_eps0)
    return DualAveragingState(
        log_eps=log_eps0, log_eps_bar=zero, h_bar=zero, step=zero, mu=math.log(10.0) + log_eps0
    )


def da_update(
    state: DualAveragingState,
    accept_prob: FloatArray,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    """One dual-averaging step toward `E[accept_prob] = target`.

    >>> import torch
    >>> from genjax_tpu_torch.inference.adaptation import da_final, da_init, da_update
    >>> s = da_init(0.1)
    >>> for a in (0.2, 0.3, 0.5):
    ...     s = da_update(s, torch.tensor(a))
    >>> bool(da_final(s) < 0.1)  # accepting too little shrinks the step
    True
    """
    t = state.step + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_eps = state.mu - (torch.sqrt(t) / gamma) * h_bar
    eta_x = t ** (-kappa)
    log_eps_bar = eta_x * log_eps + (1.0 - eta_x) * state.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, t, state.mu)


def da_final(state: DualAveragingState) -> FloatArray:
    """The averaged (final) step size."""
    return torch.exp(state.log_eps_bar)


# -- cross-chain mass estimation ---------------------------------------------


def cross_chain_inv_mass(
    traces: Trace[Any], selection: Selection, n_chains: int | None = None, mesh=None, axis: str = "chains"
):
    """A diagonal inverse mass matrix (the posterior variance of the
    selected values) from the spread across a batch of chains.

    Returns a choice map shaped like `traces.get_choices().filter(selection)`
    without the chain axis (and recorded so), with Stan-style shrinkage
    `(n/(n+5)) * var + 1e-3 * (5/(n+5))`. A leaf without the chain axis
    (shared by every chain) has no spread to measure and gets unit mass.

    With `mesh`, `traces` are this rank's chains of a batch whose chain
    axis spans `axis`: the variance is the global one (`ChainShards`), the
    same on every rank, and `n_chains`, where given, is the global count.
    """
    if mesh is not None:
        return chain_statistics(traces, n_chains, mesh, axis).inv_mass([traces], selection)
    if n_chains is None:
        n_chains = traces.particle_count()
    values = traces.get_choices().filter(selection)
    shrink = _shrink(float(n_chains))

    def leaf_var(c: Choice) -> Choice:
        v = as_float(c.v)
        if c.batched and v.dim() >= 1 and v.shape[0] == n_chains:
            return Choice(shrink * v.var(dim=0, correction=0) + 1e-3 * (1.0 - shrink), 0)
        return Choice(torch.ones(v.shape, device=v.device), 0)

    return values.map_choices(leaf_var)


def _shrink(n: float) -> float:
    return n / (n + 5.0)


@dataclasses.dataclass(frozen=True)
class DenseChains:
    """The statistics of a chain batch that one process holds whole: the
    float32 mean acceptance and `cross_chain_inv_mass` of the plain
    warmups. `n_chains` as `cross_chain_inv_mass` takes it."""

    n_chains: int | None = None

    def mean_accept(self, stats: list[torch.Tensor]) -> torch.Tensor:
        return stats[0].mean()

    def inv_mass(self, blocks: list[Trace[Any]], selection: Selection):
        return cross_chain_inv_mass(blocks[0], selection, self.n_chains)


@dataclasses.dataclass(frozen=True)
class ChainShards:
    """The statistics of a chain batch over a sharded chain axis:
    `n_chains` chains in all, of which a process moves some blocks.

    On a rank (`mesh` given) the process moves its own block, and a sum is
    its float64 partial all-reduced over `axis`. The stitched dense
    reference (`mesh` None, `parallel/certify.py`) moves every rank's block
    in rank order, and a sum is the blocks' float64 partials added in that
    order. Each block's partial is the same computation in both, so the two
    differ only in the order in which the partials are added."""

    n_chains: int
    mesh: Any = None
    axis: str = "chains"

    def total(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The global sum of the blocks' partial sums `parts` (float64)."""
        total = parts[0].clone()
        for p in parts[1:]:
            total = total + p
        if self.mesh is not None:
            from genjax_tpu_torch.parallel import collectives

            collectives.all_reduce(total, self.mesh, self.axis)
        return total

    def mean_accept(self, stats: list[torch.Tensor]) -> torch.Tensor:
        """The mean over every chain of the blocks' per-chain accept
        statistics: one global float64 pair (sum, count), as float32."""
        parts = [torch.stack([s.double().sum(), s.new_full((), s.numel(), dtype=torch.float64)]) for s in stats]
        total = self.total(parts)
        return (total[0] / total[1]).float()

    def inv_mass(self, blocks: list[Trace[Any]], selection: Selection):
        """`cross_chain_inv_mass` over every chain of the blocks, in two
        passes of float64 partial sums: the mean, then the squared
        deviations from it. A leaf carries the chain axis where it is
        batched with the block's own (local) row count; the global count
        enters the mean, the variance and the shrinkage only."""
        values = [b.get_choices().filter(selection) for b in blocks]
        leaves = [_chain_leaves(v, b.particle_count()) for b, v in zip(blocks, values)]
        chain = [i for i, v in enumerate(leaves[0]) if v is not None]
        n = float(self.n_chains)
        out = {}
        if chain:
            sums = self.total([torch.cat([row[i].double().sum(0).reshape(-1) for i in chain]) for row in leaves])
            means = _split_like(sums / n, [leaves[0][i][0] for i in chain])
            sq = self.total([
                torch.cat([torch.square(row[i].double() - m).sum(0).reshape(-1) for i, m in zip(chain, means)])
                for row in leaves
            ])
            shrink = _shrink(n)
            out = {i: (shrink * var + 1e-3 * (1.0 - shrink)).float() for i, var in zip(chain, _split_like(sq / n, means))}
        order = iter(range(len(leaves[0])))

        def leaf(c: Choice) -> Choice:
            i = next(order)
            if i in out:
                return Choice(out[i], 0)
            v = as_float(c.v)
            return Choice(torch.ones(v.shape, device=v.device), 0)

        return values[0].map_choices(leaf)


def _chain_leaves(values, n_local: int) -> list:
    """Each choice leaf of `values` as a float tensor where it carries the
    chain axis (batched, with `n_local` rows), else None."""
    row = []
    values.map_choices(lambda c: row.append(c) or c)
    out = []
    for c in row:
        v = as_float(c.v)
        out.append(v if c.batched and v.dim() >= 1 and v.shape[0] == n_local else None)
    return out


def _split_like(flat: torch.Tensor, likes: list[torch.Tensor]) -> list[torch.Tensor]:
    """`flat` cut into tensors of the shapes of `likes`, in order."""
    out, at = [], 0
    for x in likes:
        out.append(flat[at : at + x.numel()].reshape(x.shape))
        at += x.numel()
    return out


def chain_statistics(traces: Trace[Any], n_chains: int | None, mesh, axis: str):
    """Where a warmup's statistics come from: the batch itself
    (`DenseChains`, no mesh) or the global sums over `mesh`'s `axis`, of
    which `traces` hold this rank's chains (`n_chains`, where given, the
    global count)."""
    if mesh is None:
        return DenseChains(n_chains)
    shards = ChainShards(traces.particle_count() * mesh.shape[axis], mesh, axis)
    if n_chains is not None and n_chains != shards.n_chains:
        raise ValueError(f"n_chains={n_chains}, but the mesh holds {shards.n_chains} chains")
    return shards


def chain_streams(rng: torch.Generator, mesh, axis: str) -> list[torch.Generator]:
    """The generator of each block a process moves: `rng` itself without a
    mesh, this rank's fork `fork(rng, n)[rank]` with one."""
    if mesh is None:
        return [rng]
    return [fork(rng, mesh.shape[axis])[mesh.rank(axis)]]


# -- warmup driver ------------------------------------------------------------


@Pytree.dataclass
class WarmupResult(Pytree):
    """Tuned kernel parameters: pass `eps` and `inv_mass` into
    `HMC(sel, eps, L, inv_mass)` / `MALA(sel, eps, inv_mass)`."""

    eps: FloatArray
    inv_mass: Any
    accept_rate: FloatArray


def _make_request(algorithm: str, selection, eps, L, inv_mass, jitter):
    if algorithm == "hmc":
        return HMC(selection, eps, L, inv_mass, jitter)
    if algorithm == "mala":
        return MALA(selection, eps, inv_mass)
    raise ValueError(f"warmup_chains: unknown algorithm {algorithm!r}; expected 'hmc' or 'mala'.")


def accept_probability(alpha: torch.Tensor) -> torch.Tensor:
    """`min(1, exp(alpha))` per chain, 0 where the ratio is NaN."""
    return torch.where(torch.isnan(alpha), 0.0, torch.exp(torch.clamp(alpha, max=0.0)))


def phase_lengths(n_steps: int) -> tuple[int, int, int]:
    """The three phases' step counts: 30% burn-in, the rest, 20% polish."""
    n1 = max(1, int(0.3 * n_steps))
    n3 = max(1, int(0.2 * n_steps))
    return n1, max(1, n_steps - n1 - n3), n3


def adapt_blocks(
    streams: list[torch.Generator],
    blocks: list[Trace[Any]],
    stats: "DenseChains | ChainShards",
    selection: Selection,
    n_steps: int,
    step: Callable,
    eps0: float,
    target: float,
    adapt_mass: bool,
) -> tuple[list[Trace[Any]], WarmupResult]:
    """The three-phase schedule: an eps-only burn-in on unit mass, a phase
    under the first mass estimate (averaging restarted from eps = 1: under
    a variance-matched metric the target is roughly unit-scale), and an
    eps polish under the final one. `blocks[i]` moves on `streams[i]` by
    `step(rng, traces, eps, inv_mass) -> (traces, per-chain accept
    statistic)`, and the step size and the mass adapt on the statistics of
    `stats` (of the one batch, or global over a sharded chain axis)."""
    device = blocks[0].get_score().device

    def phase(blocks, da, inv_mass, n):
        hist = []
        for _ in range(n):
            eps = torch.exp(da.log_eps)
            moved = [step(g, tr, eps, inv_mass) for g, tr in zip(streams, blocks)]
            blocks = [tr for tr, _ in moved]
            mean_prob = stats.mean_accept([a for _, a in moved])
            da = da_update(da, mean_prob, target=target)
            hist.append(mean_prob)
        return blocks, da, torch.stack(hist)

    n1, n2, n3 = phase_lengths(n_steps)
    inv_mass = None
    blocks, da, _ = phase(blocks, da_init(eps0, device), inv_mass, n1)
    if adapt_mass:
        inv_mass = stats.inv_mass(blocks, selection)
        da = da_init(1.0, device)
    blocks, da, _ = phase(blocks, da, inv_mass, n2)
    if adapt_mass:
        inv_mass = stats.inv_mass(blocks, selection)
    blocks, da, hist = phase(blocks, da, inv_mass, n3)
    return blocks, WarmupResult(eps=da_final(da), inv_mass=inv_mass, accept_rate=hist.mean())


def mh_step(algorithm: str, selection: Selection, L: int, jitter: float) -> Callable:
    """One MH step of `warmup_chains`'s kernel on a batch, for
    `adapt_blocks`: the proposal's and the accept uniforms' draws from the
    block's own generator."""

    def step(rng, traces, eps, inv_mass):
        request = _make_request(algorithm, selection, eps, L, inv_mass, jitter)
        proposed, alpha, _, _ = request.edit(rng, traces, Diff.no_change(traces.get_args()))
        u = torch.rand(alpha.shape, generator=rng, device=rng.device)
        return where_tree(torch.log(u) < alpha, proposed, traces), accept_probability(alpha)

    return step


def warmup_chains(
    rng: torch.Generator,
    traces: Trace[Any],
    selection: Selection,
    n_steps: int = 200,
    *,
    algorithm: str = "hmc",
    L: int = 10,
    eps0: float = 0.1,
    target_accept: float | None = None,
    adapt_mass: bool = True,
    jitter: float = 0.2,
    n_chains: int | None = None,
    mesh=None,
    axis: str = "chains",
) -> tuple[Trace[Any], WarmupResult]:
    """Warm up a batch of chains (a trace made with a chain count): adapt
    a shared step size by dual averaging on the cross-chain mean
    acceptance probability and, with `adapt_mass`, a shared diagonal mass
    matrix from the cross-chain variance. Returns `(warmed_traces,
    WarmupResult)`; sample on with the same `jitter`:

        req = HMC(sel, result.eps, L, result.inv_mass, jitter=0.2)

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.adaptation import warmup_chains
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 2.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> rng = torch.Generator().manual_seed(0)
    >>> trs, _ = model.importance(rng, gx.ChoiceMap.kw(obs=1.0), (), n=64)
    >>> warmed, result = warmup_chains(rng, trs, gx.Selection.at["mu"], n_steps=60, L=5)
    >>> bool(result.eps > 0), result.inv_mass["mu"].shape
    (True, torch.Size([]))

    With `mesh`, `traces` are this rank's chains of a batch whose chain
    axis spans the mesh's `axis` (`n_chains`, where given, the global
    count): every rank draws from `fork(rng, n)[rank]`, adapts on the global
    statistics and returns its own warmed chains with the same result.
    """
    if target_accept is None:
        target_accept = 0.8 if algorithm == "hmc" else 0.574
    stats = chain_statistics(traces, n_chains, mesh, axis)
    (traces,), result = adapt_blocks(
        chain_streams(rng, mesh, axis), [traces], stats, selection, n_steps, mh_step(algorithm, selection, L, jitter),
        eps0, target_accept, adapt_mass,
    )
    return traces, result
