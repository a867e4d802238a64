"""One-call posterior sampling: init -> warmup -> sample -> diagnose.

Counterpart of `genjax_tpu/inference/sample.py`: `sample_posterior`,
`posterior_predictive` and `PosteriorSamples`. `sample_posterior` builds
a chain batch with one batched `importance` under the constraint, warms
it up (`adaptation.warmup_chains` for HMC and MALA, `nuts_warmup` for
NUTS, `chees_warmup` for ChEES), samples with the tuned kernel, and
reports split R-hat and ESS for every collected latent. Samples come out
with leading axes `(n_chains, n_samples)`.
"""

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import Choice, ChoiceMap, Selection
from genjax_tpu_torch.core.gfi import GenerativeFunction
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray, per_particle, plain

__all__ = ["PosteriorSamples", "posterior_predictive", "sample_posterior"]

ALGORITHMS = ("chees", "hmc", "mala", "nuts", "elliptical")


def _per_row(chm: ChoiceMap) -> ChoiceMap:
    """Every value of `chm` recorded as carrying the leading (chain or
    draw) axis."""
    return chm.map_choices(lambda c: Choice(per_particle(plain(c.v)), 1))


def posterior_predictive(
    rng: torch.Generator,
    model: GenerativeFunction[Any],
    args: tuple,
    latents: ChoiceMap,
    n_draws: int | None = None,
):
    """Sample the model's other (non-latent) sites given a batch of
    posterior latent draws: `latents` is a choice map with a leading draw
    axis (as `PosteriorSamples.flat()` gives it); each row is constrained
    in one batched `importance` and the observables are drawn fresh.
    Returns the predictive choice map (leading draw axis).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.sample import posterior_predictive, sample_posterior
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> rng = torch.Generator().manual_seed(0)
    >>> out = sample_posterior(rng, model, gx.ChoiceMap.kw(obs=1.0), algorithm="hmc",
    ...     n_chains=32, n_warmup=50, n_samples=60, L=5)
    >>> pred = posterior_predictive(rng, model, (), out.flat())
    >>> pred["obs"].shape  # one predictive obs per posterior draw
    torch.Size([1920])
    """
    if n_draws is None:
        n_draws = pytree.tree_leaves(latents)[0].shape[0]
    trs, _ = model.importance(rng, _per_row(latents), args, n=n_draws)
    return trs.get_choices().filter(~latents.get_selection())


@Pytree.dataclass
class PosteriorSamples(Pytree):
    """The result: `samples` holds `(n_chains, n_samples, ...)` tensors
    (a choice map of the selected addresses), with matching per-leaf
    `rhat` and `ess` and the warmup's tuned kernel parameters."""

    samples: Any
    rhat: Any
    ess: Any
    accept_rate: FloatArray
    tuned: Any

    def flat(self):
        """The samples flattened to `(n_chains * n_samples, ...)` per leaf."""
        return pytree.tree_map(lambda v: v.reshape((-1,) + v.shape[2:]), self.samples)


def sample_posterior(
    rng: torch.Generator,
    model: GenerativeFunction[Any],
    constraint: ChoiceMap,
    args: tuple = (),
    *,
    selection: Selection | None = None,
    algorithm: str = "chees",
    n_chains: int = 64,
    n_warmup: int = 200,
    n_samples: int = 500,
    L: int = 10,
    max_depth: int = 6,
    thin_burn: int = 0,
    init: "ChoiceMap | Callable[[torch.Generator], ChoiceMap] | None" = None,
) -> PosteriorSamples:
    """Sample `p(latents | constraint)` for `model(*args)` with a batch of
    `n_chains` chains on the generator's device.

    `selection` defaults to every unconstrained address (the latents),
    which must be continuous for the gradient-based kernels. `algorithm`
    is `"chees"` (automatic trajectory lengths, the default), `"hmc"`
    (fixed L with trajectory jitter), `"mala"`, `"nuts"` (up to
    `2**max_depth - 1` leapfrog steps per draw) or `"elliptical"`
    (tuning-free slice moves for zero-mean Gaussian-prior latents; the
    first `n_warmup` sweeps are dropped as burn-in).

    `init` overrides the initial values of some latents: a choice map, or
    a callable `rng -> ChoiceMap`, whose values carry a leading chain axis
    of length `n_chains` (Stan's `uniform(-2, 2)` starts, for example).
    Those latents are still sampled by the kernel.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.sample import sample_posterior
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> out = sample_posterior(torch.Generator().manual_seed(0), model, gx.ChoiceMap.kw(obs=1.0),
    ...     n_chains=32, n_warmup=60, n_samples=80, algorithm="hmc", L=5)
    >>> out.samples["mu"].shape
    torch.Size([32, 80])
    >>> bool(out.rhat["mu"] < 1.1), bool(abs(out.samples["mu"].mean() - 0.5) < 0.2)
    (True, True)
    """
    from genjax_tpu_torch.inference.diagnostics import effective_sample_size, split_rhat

    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"sample_posterior: unknown algorithm {algorithm!r}; expected 'chees', 'hmc', 'mala', 'nuts', "
            "or 'elliptical'."
        )
    merged = constraint
    if init is not None:
        merged = constraint | _per_row(init if isinstance(init, ChoiceMap) else init(rng))
    traces, _ = model.importance(rng, merged, args, n=n_chains)
    if selection is None:
        # From the observations only: latents given by `init` are latents.
        selection = ~constraint.get_selection()

    def collect(tr):
        return tr.get_choices().filter(selection)

    if algorithm == "chees":
        from genjax_tpu_torch.inference.chees import chees_warmup, run_chees_chains

        traces, tuned = chees_warmup(rng, traces, selection, n_steps=n_warmup)
        # run_chees_chains stacks the steps in front: (steps, chains, ...).
        _, collected = run_chees_chains(rng, traces, selection, tuned, n_samples, collect=collect)
        samples = pytree.tree_map(lambda v: v.transpose(0, 1), collected)
        accept = tuned.accept_rate
    elif algorithm in ("hmc", "mala"):
        from genjax_tpu_torch.inference.adaptation import warmup_chains
        from genjax_tpu_torch.inference.mcmc import run_chains
        from genjax_tpu_torch.inference.requests import HMC, MALA

        traces, tuned = warmup_chains(rng, traces, selection, n_steps=n_warmup, algorithm=algorithm, L=L)
        if algorithm == "hmc":
            req = HMC(selection, tuned.eps, L, tuned.inv_mass, jitter=0.2)
        else:
            req = MALA(selection, tuned.eps, tuned.inv_mass)
        _, samples = run_chains(rng, traces, req, n_samples, collect=collect)
        accept = tuned.accept_rate
    elif algorithm == "nuts":
        from genjax_tpu_torch.inference.mcmc import run_chains
        from genjax_tpu_torch.inference.requests.nuts import NUTS, nuts_warmup

        traces, tuned = nuts_warmup(rng, traces, selection, n_steps=n_warmup, max_depth=max_depth)
        req = NUTS(selection, tuned.eps, max_depth, tuned.inv_mass)
        _, samples = run_chains(rng, traces, req, n_samples, collect=collect)
        accept = tuned.accept_rate
    else:
        # Tuning-free: no adaptation; the first n_warmup sweeps are burn-in.
        # Needs zero-mean Gaussian priors over the selected sites (use
        # `EllipticalSlice` directly for another mean).
        from genjax_tpu_torch.inference.mcmc import run_chains
        from genjax_tpu_torch.inference.requests import EllipticalSlice

        _, samples = run_chains(rng, traces, EllipticalSlice(selection, mean=0.0), n_warmup + n_samples, collect=collect)
        samples = pytree.tree_map(lambda v: v[:, n_warmup:], samples)
        accept = torch.ones((), device=traces.get_score().device)  # slice moves always accept
        tuned = None

    if thin_burn:
        samples = pytree.tree_map(lambda v: v[:, thin_burn:], samples)
    return PosteriorSamples(
        samples=samples,
        rhat=split_rhat(samples),
        ess=effective_sample_size(samples),
        accept_rate=accept,
        tuned=tuned,
    )
