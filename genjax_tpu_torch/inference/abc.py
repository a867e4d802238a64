"""Approximate Bayesian computation: likelihood-free inference from the
GFI's simulator.

Counterpart of `genjax_tpu/inference/abc.py`: `abc_rejection` and
`ABCSMC`. ABC approximates the posterior by matching summaries of
simulated data to the observed summary within a tolerance; nothing beyond
the GFI is needed (`simulate` is the simulator, `Update` and `Regenerate`
move the latents and re-simulate the data, `project` scores the prior).

`ABCSMC` is the adaptive SMC sampler of Del Moral et al. (2012) in its
dense, fixed-shape form: each generation tightens the tolerance to a
quantile of the population's distances, resamples the survivors
systematically, and applies MCMC moves whose "likelihood" is the
tolerance indicator. JAX `vmap`s the particles and scans the generations
and moves; here the particles are one batched trace and the generations
and moves Python loops, each move one batched edit with dense selects.
The resample's reduction of the survivor weights is one `ops.logsumexp`
launch per generation; nothing is read on the host.
"""

from typing import Any, Callable

import torch

from genjax_tpu_torch.core.choice_map import Selection
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import take_rows
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.pytree import Pytree, ravel_pytree, tree_map
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.core.typing import on_device, plain
from genjax_tpu_torch.inference.mcmc import share_chain_args
from genjax_tpu_torch.inference.smc import systematic_resample

__all__ = ["ABCSMC", "abc_rejection"]


def _distances(summary: Any, observed: Any, n: int, device) -> torch.Tensor:
    """The Euclidean distance of each particle's summary (the particle axis
    in front, or none where the summary is shared) from the observed one."""
    obs = on_device(plain(observed), device)
    s = on_device(plain(summary), device).to(obs.dtype) if obs.is_floating_point() else on_device(plain(summary), device)
    diff = torch.broadcast_to(s, (n, *obs.shape)) - obs
    return torch.sqrt(torch.square(diff).reshape(n, -1).sum(-1))


def abc_rejection(
    rng: torch.Generator,
    model: GenerativeFunction[Any],
    args: tuple,
    summary_fn: Callable[[Trace[Any]], Any],
    observed_summary: Any,
    tolerance: float,
    n_particles: int,
) -> dict:
    """Plain rejection ABC: simulate `n_particles` traces from the prior
    (one batched `simulate`), accept those whose summary lands within
    `tolerance` (Euclidean) of the observed summary. Returns the full
    batch with an `accepted` mask (dense: filter on the host if needed),
    the distances and the acceptance rate. `summary_fn` takes the batched
    trace and returns the summaries with the particle axis in front."""
    traces = model.simulate(rng, args, n_particles)
    d = _distances(summary_fn(traces), observed_summary, n_particles, traces.get_score().device)
    accepted = d < tolerance
    return {
        "traces": traces,
        "distances": d,
        "accepted": accepted,
        "accept_rate": accepted.to(torch.float32).mean(),
    }


@Pytree.dataclass
class ABCSMC(Pytree):
    """Adaptive ABC-SMC over the latents selected by `selection`.

    `summary_fn(traces) -> summaries` computes the data summaries of a
    batch of traces (the particle axis in front); `observed_summary` is
    their target. Each of `n_generations` the tolerance drops to the
    `quantile` of the distances, survivors are systematically resampled,
    and `n_moves` indicator-MH moves (a Gaussian perturbation scaled by
    `move_scale` x the population std per dimension, fresh data
    simulated by `Regenerate`) rejuvenate the population.

    `run` returns: `traces` (the final population, equally weighted draws
    from the eps-final ABC posterior), `distances`, `epsilons` (the
    adaptive schedule) and `accept_rate` (mean MH acceptance).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.abc import ABCSMC
    >>> @gx.gen
    ... def model():
    ...     t = gx.normal(0.0, 1.0) @ "theta"
    ...     _ = gx.normal(t, 0.5) @ "y"
    >>> alg = ABCSMC(model, (), gx.Selection.at["theta"],
    ...              summary_fn=lambda tr: tr.get_choices()["y"],
    ...              observed_summary=1.0, n_particles=256, n_generations=5)
    >>> out = alg.run(torch.Generator().manual_seed(0))
    >>> out["epsilons"].shape
    torch.Size([5])
    """

    model: GenerativeFunction[Any]
    args: tuple
    selection: Selection
    summary_fn: Callable[[Trace[Any]], Any] = Pytree.static()
    observed_summary: Any = None
    n_particles: int = Pytree.static(default=1024)
    n_generations: int = Pytree.static(default=8)
    n_moves: int = Pytree.static(default=5)
    quantile: float = Pytree.static(default=0.5)
    move_scale: float = Pytree.static(default=1.0)

    def _distance(self, traces) -> torch.Tensor:
        return _distances(self.summary_fn(traces), self.observed_summary, self.n_particles, traces.get_score().device)

    def _flat_latents(self, traces):
        """The selected latents as an `(n, d)` matrix, row i particle i's
        raveled values in JAX's leaf order; and the map back."""
        return ravel_pytree(tree_map(plain, traces.get_choices().filter(self.selection)), (self.n_particles,))

    def tolerance(self, d: torch.Tensor) -> torch.Tensor:
        """The generation's tolerance: the linear `quantile` of the
        distances (`jnp.quantile`'s rule, which `torch.quantile` shares)."""
        return torch.quantile(d, self.quantile)

    def move_scales(self, traces) -> torch.Tensor:
        """The perturbation's scale per latent dimension: `move_scale` x the
        population standard deviation (ddof 0, as `jnp.std`) + 1e-8."""
        flat, _ = self._flat_latents(traces)
        return self.move_scale * torch.std(flat, dim=0, correction=0) + 1e-8

    def _move(self, rng: torch.Generator, traces, d, eps, scales):
        """One indicator-MH move of every particle: perturb the latents,
        re-simulate the data, accept on the prior ratio AND the tolerance
        indicator."""
        argdiffs = Diff.no_change(traces.get_args())
        flat, unravel = self._flat_latents(traces)
        prop = flat + scales * torch.randn(flat.shape, generator=rng, device=flat.device, dtype=flat.dtype)
        cand, _, _, _ = Update(unravel(prop)).edit(rng, traces, argdiffs)
        # Fresh data given the proposed latents: regenerate everything NOT
        # selected (the observation sites) with one more edit.
        cand, _, _, _ = Regenerate(~self.selection).edit(rng, cand, argdiffs)
        d_cand = self._distance(cand)
        prior_delta = cand.project(rng, self.selection) - traces.project(rng, self.selection)
        u = torch.rand(prior_delta.shape, generator=rng, device=rng.device)
        accept = (torch.log(u) < prior_delta) & (d_cand <= eps)
        return where_tree(accept, cand, traces), torch.where(accept, d_cand, d), accept

    def run(self, rng: torch.Generator) -> dict:
        n = self.n_particles
        traces = self.model.simulate(rng, self.args, n)
        # The model arguments are stored once, not broadcast per particle.
        traces = share_chain_args(traces, self.args)
        d = self._distance(traces)
        acc_sum = torch.zeros((), device=d.device)
        epsilons = []
        for _ in range(self.n_generations):
            eps = self.tolerance(d)
            # <= not <: when the population collapses (or summaries are
            # discrete) the quantile can EQUAL the smallest distance, and a
            # strict < would leave no survivor (all -inf weights, NaN).
            lw = torch.where(d <= eps, 0.0, -torch.inf)
            anc = systematic_resample(rng, lw, n)
            traces, d = take_rows(traces, anc), d.index_select(0, anc)
            scales = self.move_scales(traces)
            for _ in range(self.n_moves):
                traces, d, accs = self._move(rng, traces, d, eps, scales)
                acc_sum = acc_sum + accs.to(torch.float32).mean()
            epsilons.append(eps)
        total = float(self.n_generations * self.n_moves)
        return {
            "traces": traces,
            "distances": d,
            "epsilons": torch.stack(epsilons),
            "accept_rate": acc_sum / total,
        }
