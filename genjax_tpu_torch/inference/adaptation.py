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
"""

import math
from typing import Any

import torch

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


def cross_chain_inv_mass(traces: Trace[Any], selection: Selection, n_chains: int | None = None):
    """A diagonal inverse mass matrix (the posterior variance of the
    selected values) from the spread across a batch of chains.

    Returns a choice map shaped like `traces.get_choices().filter(selection)`
    without the chain axis (and recorded so), with Stan-style shrinkage
    `(n/(n+5)) * var + 1e-3 * (5/(n+5))`. A leaf without the chain axis
    (shared by every chain) has no spread to measure and gets unit mass.
    """
    if n_chains is None:
        n_chains = traces.particle_count()
    values = traces.get_choices().filter(selection)
    n = float(n_chains)
    shrink = n / (n + 5.0)

    def leaf_var(c: Choice) -> Choice:
        v = as_float(c.v)
        if c.batched and v.dim() >= 1 and v.shape[0] == n_chains:
            return Choice(shrink * v.var(dim=0, correction=0) + 1e-3 * (1.0 - shrink), 0)
        return Choice(torch.ones(v.shape, device=v.device), 0)

    return values.map_choices(leaf_var)


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


def _adaptive_phase(rng, traces, selection, algorithm, L, inv_mass, da, n_steps, target, jitter):
    """`n_steps` MH steps over the batch with a shared step size, adapted
    after each step."""
    argdiffs = Diff.no_change(traces.get_args())
    probs = []
    for _ in range(n_steps):
        request = _make_request(algorithm, selection, torch.exp(da.log_eps), L, inv_mass, jitter)
        proposed, alpha, _, _ = request.edit(rng, traces, argdiffs)
        u = torch.rand(alpha.shape, generator=rng, device=rng.device)
        traces = where_tree(torch.log(u) < alpha, proposed, traces)
        mean_prob = accept_probability(alpha).mean()
        da = da_update(da, mean_prob, target=target)
        probs.append(mean_prob)
    return traces, da, torch.stack(probs)


def phase_lengths(n_steps: int) -> tuple[int, int, int]:
    """The three phases' step counts: 30% burn-in, the rest, 20% polish."""
    n1 = max(1, int(0.3 * n_steps))
    n3 = max(1, int(0.2 * n_steps))
    return n1, max(1, n_steps - n1 - n3), n3


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
    """
    if target_accept is None:
        target_accept = 0.8 if algorithm == "hmc" else 0.574
    if n_chains is None:
        n_chains = traces.particle_count()
    n1, n2, n3 = phase_lengths(n_steps)
    device = traces.get_score().device

    inv_mass = None
    traces, da, _ = _adaptive_phase(
        rng, traces, selection, algorithm, L, inv_mass, da_init(eps0, device), n1, target_accept, jitter
    )
    if adapt_mass:
        inv_mass = cross_chain_inv_mass(traces, selection, n_chains)
        # The metric changed; under a variance-matched metric the target is
        # roughly unit-scale, so averaging restarts from eps = 1.
        da = da_init(1.0, device)
    traces, da, _ = _adaptive_phase(rng, traces, selection, algorithm, L, inv_mass, da, n2, target_accept, jitter)
    if adapt_mass:
        inv_mass = cross_chain_inv_mass(traces, selection, n_chains)
    traces, da, accept_hist = _adaptive_phase(
        rng, traces, selection, algorithm, L, inv_mass, da, n3, target_accept, jitter
    )
    return traces, WarmupResult(eps=da_final(da), inv_mass=inv_mass, accept_rate=accept_hist.mean())
