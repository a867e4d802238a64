"""Replica-exchange MCMC (parallel tempering): a ladder of likelihood-
tempered chains that exchange temperatures, so cold chains inherit the
mode-hopping of hot ones.

Counterpart of `genjax_tpu/inference/parallel_tempering.py`:
`tempered_mh`, `ParallelTempering` and `PTResult`. The bridge densities
are `p(z) p(y | z)^beta`, the family of `inference/tempered.py`, whose
re-tempering identity (`tempered.retempered_log_alpha`) this module
shares, with `loglik` read off the GFI as `trace.project(observed
addresses)`.

JAX `vmap`s the T replicas and scans the sweeps (`lax.scan`). Here the T
replicas are one trace with a chain axis of length T, each sweep's moves
one batched tempered-MH step per move with one inverse temperature per
replica, and the sweeps a Python loop. The exchange swaps TEMPERATURE
ASSIGNMENTS, a `(T,)` permutation `perm` with `perm[rank] = replica`,
never replica states, on the deterministic even-odd schedule (the parity
alternates every sweep), with dense selects. No sweep reads the device on
the host.
"""

from typing import Any, Callable, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import Choice, ChoiceMap
from genjax_tpu_torch.core.concepts import EditRequest
from genjax_tpu_torch.core.mask import Mask
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray, on_device, per_particle, plain
from genjax_tpu_torch.inference.mcmc import share_chain_args
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.inference.tempered import tempered_mh

R = TypeVar("R")

__all__ = ["PTResult", "ParallelTempering", "deo_exchange", "tempered_mh"]


def deo_exchange(perm: torch.Tensor, logliks: torch.Tensor, betas: torch.Tensor, parity: int, log_u: torch.Tensor):
    """The exchange phase of one sweep: propose swapping the temperatures of
    the adjacent rungs `(r, r + 1)` with `r % 2 == parity`, each accepted
    where `log_u[r] < (betas[r] - betas[r + 1]) (ll[r + 1] - ll[r])`, `ll`
    the log-likelihoods by rung. Only the permutation moves. Returns
    `(perm, accepted, attempted)`, the last two one flag per rung (the last
    rung's always False)."""
    n = betas.shape[0]
    ranks = torch.arange(n, device=perm.device)
    ll_rank = logliks[perm]
    delta = (betas - torch.roll(betas, -1)) * (torch.roll(ll_rank, -1) - ll_rank)
    is_left = (ranks % 2 == parity) & (ranks < n - 1)
    acc = is_left & (log_u < delta)
    # The right partner of each accepted swap (an in-place `[0] = False`
    # would copy a host scalar to the card: a synchronisation per sweep).
    acc_prev = torch.roll(acc, 1) & (ranks > 0)
    perm = torch.where(acc, torch.roll(perm, -1), torch.where(acc_prev, torch.roll(perm, 1), perm))
    return perm, acc, is_left


def _per_replica(chm: ChoiceMap, n: int, device) -> ChoiceMap:
    """A constraint's values copied once per replica, so each replica's
    value is its own to move (a shared constrained value would be stored
    once, for every replica)."""

    def one(c: Choice) -> ChoiceMap:
        if isinstance(c.v, Mask) or c.batched:
            return c
        v = on_device(c.v, device)
        return Choice(v.expand(n, *v.shape).clone(), 1)

    return chm.map_choices(one)


@Pytree.dataclass
class ParallelTempering(Generic[R], Pytree):
    """Replica-exchange MCMC over a beta ladder.

    `betas` is the (T,) inverse-temperature ladder, descending from
    `betas[0] = 1.0` (the cold chain whose samples are collected) toward
    hot, near-prior replicas. Within-temperature moves apply `request` (or
    `request_fn(beta)` for temperature-adapted kernels; `beta` is then one
    value per replica, a `per_particle` tensor, e.g. for
    `GaussianDrift(sel, 0.5 / torch.sqrt(beta))`) `n_moves` times per
    sweep; the exchange phase then proposes the even-odd adjacent swaps.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.parallel_tempering import ParallelTempering
    >>> from genjax_tpu_torch.inference.requests import GaussianDrift
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> target = gx.Target(model, (), gx.ChoiceMap.kw(y=1.0))
    >>> pt = ParallelTempering(betas=torch.tensor([1.0, 0.5, 0.25]),
    ...                        request=GaussianDrift(gx.Selection.at["mu"], 0.8))
    >>> out = pt.run(torch.Generator().manual_seed(0), target, 200, collect=lambda t: t.get_choices()["mu"])
    >>> out.collected.shape, bool((out.swap_rates >= 0.0).all())
    (torch.Size([200]), True)
    """

    betas: FloatArray
    request: EditRequest | None = None
    request_fn: Callable[[FloatArray], EditRequest] | None = Pytree.static(default=None)
    n_moves: int = Pytree.static(default=1)

    def _request_for(self, beta: FloatArray) -> EditRequest:
        if self.request_fn is not None:
            return self.request_fn(beta)
        assert self.request is not None, "ParallelTempering needs `request` or `request_fn`."
        return self.request

    def init(self, rng: torch.Generator, target: Target[R], constraint: ChoiceMap | None = None):
        """Importance-initialize one replica per ladder rung (optionally from
        `constraint`, e.g. to start every replica at a known point) and
        return `(traces, logliks)`: one trace with a replica axis, the
        model arguments and observations stored once."""
        n = self.betas.shape[0]
        chm = ChoiceMap.empty() if constraint is None else _per_replica(constraint, n, rng.device)
        traces, _ = target.importance(rng, chm, n)
        traces = share_chain_args(traces, target.args)
        logliks = traces.project(rng, target.constraint.get_selection())
        return traces, logliks

    def run(
        self,
        rng: torch.Generator,
        target: Target[R],
        n_sweeps: int,
        collect: Callable[[Any], Any] | None = None,
        init_constraint: ChoiceMap | None = None,
    ) -> "PTResult":
        """Run `n_sweeps` sweeps (moves, then the exchange); collects
        `collect(traces)` (a statistic with the replica axis in front)
        from the replica holding `betas[0]` after every sweep, stacked
        along a leading sweep axis."""
        n = self.betas.shape[0]
        obs_sel = target.constraint.get_selection()
        traces, logliks = self.init(rng, target, init_constraint)
        betas = torch.as_tensor(self.betas, dtype=logliks.dtype).to(logliks.device)
        perm = torch.arange(n, device=logliks.device)
        collected, accs, attempts = [], [], []
        for sweep in range(n_sweeps):
            # Each replica's inverse temperature: replica perm[r] holds rung r.
            beta_by_replica = per_particle(torch.zeros_like(betas).scatter(0, perm, betas))
            request = self._request_for(beta_by_replica)
            beta = plain(beta_by_replica)
            for _ in range(self.n_moves):
                traces, logliks, _ = tempered_mh(rng, traces, request, beta, obs_sel, logliks)
            log_u = torch.log(torch.rand(n, generator=rng, device=rng.device))
            perm, acc, is_left = deo_exchange(perm, logliks, betas, sweep % 2, log_u)
            if collect is not None:
                cold = perm[:1]
                collected.append(pytree.tree_map(lambda v: v.index_select(0, cold).squeeze(0), collect(traces)))
            accs.append(acc[:-1])
            attempts.append(is_left[:-1])
        n_att = torch.clamp(torch.stack(attempts).sum(0), min=1)
        swap_rates = torch.stack(accs).sum(0) / n_att
        out = pytree.tree_map(lambda *xs: torch.stack(xs), *collected) if collected else None
        return PTResult(traces, logliks, perm, out, swap_rates)


@Pytree.dataclass
class PTResult(Pytree):
    """Final replica states plus the per-sweep cold-chain collection.

    `traces` are the T replica states (one trace with a replica axis),
    `perm` the final rung->replica assignment (`perm[0]` is the cold
    replica), `collected` the stacked per-sweep `collect` outputs from the
    cold rung, and `swap_rates` the per-adjacent-pair exchange acceptance
    rates (the ladder-tuning diagnostic: aim for roughly uniform 0.2-0.6;
    a rate near zero means the ladder has a gap there)."""

    traces: Any
    logliks: FloatArray
    perm: Any
    collected: Any
    swap_rates: FloatArray
