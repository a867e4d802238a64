"""Variational inference: guide distributions whose sites carry ADEV
strategies, gradient estimators of variational objectives (ELBO, IWELBO,
PWake, QWake), the `fit` driver and automatic mean-field VI (`advi`).

Counterpart of `genjax_tpu/inference/vi.py`. Each objective is a factory
returning `grad_estimate(rng, args)`: an unbiased estimate of the gradient
of a (negated) objective with respect to `args`, from one execution of the
loss under `expectation` (`adev/core.py`) and one backward pass. `rng` is
the program's generator: the loss draws from it, and the ADEV sites from
generators seeded by its state.

* ELBO(q)   = E_q[log p(x, z) - log q(z)]: the one-particle log Z-hat of
  importance sampling with q as proposal.
* IWELBO_N  = E[log (1/N) sum_i p(x, z_i) / q(z_i)] (Burda et al. 2016): the
  N-particle SIR log Z-hat; the guide's sites are one batch of N lanes.
* PWake     = E_{z~q*}[-log p(x, z)]: the wake-phase model gradient of
  reweighted wake-sleep (Bornschein & Bengio 2015).
* QWake     = E_{z~q*}[-log q(z)]: the wake-phase proposal gradient.
"""

from functools import partial
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.adev.core import ADEVPrimitive, expectation, fork, sample_primitive
from genjax_tpu_torch.adev.primitives import categorical_enum_parallel
from genjax_tpu_torch.adev.primitives import dirichlet_implicit as _dirichlet_implicit_prim
from genjax_tpu_torch.adev.primitives import flip_enum as _flip_enum_prim
from genjax_tpu_torch.adev.primitives import flip_mvd as _flip_mvd_prim
from genjax_tpu_torch.adev.primitives import gamma_implicit as _gamma_implicit_prim
from genjax_tpu_torch.adev.primitives import geometric_reinforce as _geometric_reinforce_prim
from genjax_tpu_torch.adev.primitives import mv_normal_diag_reparam as _mv_normal_diag_reparam_prim
from genjax_tpu_torch.adev.primitives import normal_reinforce as _normal_reinforce_prim
from genjax_tpu_torch.adev.primitives import normal_reparam as _normal_reparam_prim
from genjax_tpu_torch.core.choice_map import Choice, ChoiceMap, Static
from genjax_tpu_torch.core.typing import as_generator, on_device
from genjax_tpu_torch.distributions.distribution import ExactDensity, exact_density
from genjax_tpu_torch.distributions.library import (
    _dirichlet_logpdf,
    _flip_logpdf,
    _gamma_logpdf,
    _geometric_logpdf,
    _mv_normal_diag_logpdf,
    _normal_logpdf,
    categorical,
)
from genjax_tpu_torch.inference.smc import Importance, ImportanceK
from genjax_tpu_torch.inference.sp import SampleDistribution, Target


def adev_distribution(
    adev_primitive: ADEVPrimitive,
    differentiable_logpdf: Callable[..., Any],
    name: str,
    param_event_extra: Any = 0,
) -> ExactDensity[Any]:
    """An `ExactDensity` whose sampler is an ADEV sample site: a
    distribution for `@gen` guides whose strategy acts under `expectation`
    losses (and which samples plainly elsewhere). `param_event_extra` as in
    `Distribution` (`categorical_enum`'s probabilities have an axis that the
    value lacks)."""

    def sampler(rng: torch.Generator, *args, n=None) -> Any:
        return sample_primitive(adev_primitive, *args, rng=rng, n=n)

    density = exact_density(sampler, differentiable_logpdf, name)
    type(density).param_event_extra = param_event_extra
    return density


flip_enum = adev_distribution(_flip_enum_prim, _flip_logpdf, "flip_enum")
flip_mvd = adev_distribution(_flip_mvd_prim, _flip_logpdf, "flip_mvd")
categorical_enum = adev_distribution(
    categorical_enum_parallel,
    lambda v, probs: categorical.logpdf(v, probs=probs),
    "categorical_enum",
    (1,),
)
normal_reinforce = adev_distribution(_normal_reinforce_prim, _normal_logpdf, "normal_reinforce")
normal_reparam = adev_distribution(_normal_reparam_prim, _normal_logpdf, "normal_reparam")
mv_normal_diag_reparam = adev_distribution(
    _mv_normal_diag_reparam_prim, _mv_normal_diag_logpdf, "mv_normal_diag_reparam"
)
geometric_reinforce = adev_distribution(_geometric_reinforce_prim, _geometric_logpdf, "geometric_reinforce")
# Implicitly reparameterized guides over positive and simplex supports.
gamma_reparam = adev_distribution(_gamma_implicit_prim, _gamma_logpdf, "gamma_reparam")
dirichlet_reparam = adev_distribution(_dirichlet_implicit_prim, _dirichlet_logpdf, "dirichlet_reparam")

GradientEstimate = Any


def ELBO(
    guide: SampleDistribution, make_target: Callable[..., Target[Any]]
) -> Callable[[torch.Generator, tuple], GradientEstimate]:
    """Gradient estimator for the (negated) evidence lower bound.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference import Target, vi
    >>> @gx.gen
    ... def model(_vmu):
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> @gx.marginal()
    ... @gx.gen
    ... def guide(target):
    ...     (vmu,) = target.args
    ...     _ = vi.normal_reparam(vmu, 1.0) @ "mu"
    >>> step = vi.ELBO(guide, lambda vmu: Target(model, (vmu,), gx.ChoiceMap.kw(y=2.0)))
    >>> (grad,) = step(torch.Generator().manual_seed(0), (0.0,))
    >>> bool(grad < 0)  # pushes the variational mean toward the posterior (1.0)
    True
    """

    def grad_estimate(rng: torch.Generator, args: tuple) -> GradientEstimate:
        @expectation
        def negated_elbo(*target_args):
            target = make_target(*target_args)
            return -Importance(target, guide).estimate_normalizing_constant(rng, target)

        return negated_elbo.grad_estimate(rng, args)

    return grad_estimate


def IWELBO(
    proposal: SampleDistribution, make_target: Callable[..., Target[Any]], N: int
) -> Callable[[torch.Generator, tuple], GradientEstimate]:
    """Gradient estimator for the (negated) N-particle importance-weighted
    ELBO: the proposal's sites are one batch of N lanes, so each strategy
    runs its batched form (`adev/primitives.py`)."""

    def grad_estimate(rng: torch.Generator, args: tuple) -> GradientEstimate:
        @expectation
        def negated_iwelbo(*target_args):
            target = make_target(*target_args)
            return -ImportanceK(target, proposal, k_particles=N).estimate_normalizing_constant(rng, target)

        return negated_iwelbo.grad_estimate(rng, args)

    return grad_estimate


def PWake(
    posterior_approx: SampleDistribution, make_target: Callable[..., Target[Any]]
) -> Callable[[torch.Generator, tuple], GradientEstimate]:
    """Wake-phase model-parameter gradient of reweighted wake-sleep."""

    def grad_estimate(rng: torch.Generator, args: tuple) -> GradientEstimate:
        # Three streams: `rng` drives the walk (its sites), and the draw and
        # the score get generators of their own, forked inside the loss from
        # the program's generator so that every execution forks the same.
        @expectation
        def wake_theta_loss(*target_args):
            k_draw, k_score = fork(rng, 2)
            target = make_target(*target_args)
            _, latents = posterior_approx.random_weighted(k_draw, target)
            model_trace, _ = target.importance(k_score, latents)
            return -model_trace.get_score()

        return wake_theta_loss.grad_estimate(rng, args)

    return grad_estimate


def QWake(
    proposal: SampleDistribution,
    posterior_approx: SampleDistribution,
    make_target: Callable[..., Target[Any]],
) -> Callable[[torch.Generator, tuple], GradientEstimate]:
    """Wake-phase proposal-parameter gradient of reweighted wake-sleep:
    drives `proposal`'s density toward `posterior_approx`'s samples."""

    def grad_estimate(rng: torch.Generator, args: tuple) -> GradientEstimate:
        @expectation
        def wake_phi_loss(*target_args):
            k_draw, k_density = fork(rng, 2)
            target = make_target(*target_args)
            _, latents = posterior_approx.random_weighted(k_draw, target)
            return -proposal.estimate_logpdf(k_density, latents, target)

        return wake_phi_loss.grad_estimate(rng, args)

    return grad_estimate


# -- the optimization driver and automatic guides ------------------------------


def fit(
    rng: torch.Generator | int,
    grad_estimate: Callable[[torch.Generator, tuple], GradientEstimate],
    init_params,
    n_steps: int = 500,
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    device: torch.device | str = "cuda",
):
    """Run a variational objective's gradient estimator through an
    optimizer for `n_steps` steps (JAX's `lax.scan` over an optax loop, as a
    Python loop with no host synchronisation per step).

    `grad_estimate` is any objective's (`ELBO(...)`, `IWELBO(...)`, ...);
    `init_params` the pytree of variational parameters it takes, placed on
    `device`; `optimizer` maps the parameter tensors to a
    `torch.optim.Optimizer` (default Adam at 1e-2, whose betas and eps are
    `optax.adam`'s). `rng` is a generator on `device` or an int seed.
    Returns `(params, grad_norms)`, the norms one per step, on the device.
    """
    rng = as_generator(rng, device)
    leaves, spec = pytree.tree_flatten(init_params)
    params = [on_device(p, device, torch.float32).detach().clone().requires_grad_() for p in leaves]
    opt = (optimizer or partial(torch.optim.Adam, lr=1e-2))(params)
    norms = []
    for _ in range(n_steps):
        grads = pytree.tree_leaves(grad_estimate(rng, pytree.tree_unflatten(params, spec)))
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        norms.append(torch.sqrt(sum((g * g).sum() for g in grads)))
    out = pytree.tree_unflatten([p.detach() for p in params], spec)
    return out, torch.stack(norms) if norms else torch.zeros(0, device=device)


def mean_field_guide(latent_specs: dict):
    """A mean-field Gaussian guide over flat real-valued latent addresses.
    `latent_specs` is `{address: shape}` (shapes `()` or `(n,)`). The guide
    reads its parameters from the LAST target argument: `{address: {"mu":
    ..., "log_sigma": ...}}`."""
    from genjax_tpu_torch.inference.sp import marginal
    from genjax_tpu_torch.lang.static import gen

    specs = tuple(sorted((str(a), tuple(s)) for a, s in latent_specs.items()))
    for addr, shape in specs:
        if len(shape) > 1:
            raise NotImplementedError(
                f"mean_field_guide: latent {addr!r} has rank-{len(shape)} shape; only scalar and vector "
                "latents are supported (reshape in the model, or write the guide by hand)."
            )

    @marginal()
    @gen
    def guide(target):
        params = target.args[-1]
        for addr, shape in specs:
            mu = params[addr]["mu"]
            sigma = torch.exp(params[addr]["log_sigma"])
            if shape == ():
                _ = normal_reparam(mu, sigma) @ addr
            else:
                _ = mv_normal_diag_reparam(mu, sigma) @ addr

    return guide


def mean_field_init(latent_specs: dict, device: torch.device | str = "cuda") -> dict:
    """Zero parameters for `mean_field_guide`, on `device`."""
    return {
        str(a): {"mu": torch.zeros(tuple(s), device=device), "log_sigma": torch.zeros(tuple(s), device=device)}
        for a, s in latent_specs.items()
    }


def _discover_flat_latents(model, args: tuple, constraint: ChoiceMap) -> dict:
    """Top-level unconstrained addresses and their shapes, from a zero
    trace."""
    chm = model.get_zero_trace(*args).get_choices()
    latents = chm.filter(~constraint.get_selection())
    specs = {}
    if latents.static_is_empty():
        return specs
    if not isinstance(latents, Static):
        raise NotImplementedError("advi: only a model with flat (top-level) string addresses is auto-guided.")
    for addr, sub in latents.children.items():
        if not isinstance(sub, Choice):
            raise NotImplementedError(
                "advi: only flat (top-level) latent addresses are auto-guided; found nested path "
                f"{addr!r}. Write the guide with mean_field_guide or by hand for nested models."
            )
        leaf = torch.as_tensor(sub.get_value())
        if not leaf.is_floating_point():
            raise NotImplementedError(
                f"advi: latent {addr!r} has dtype {leaf.dtype}: a Gaussian mean-field guide only makes sense "
                "for real-valued latents; marginalize discrete sites in the model or write the guide by hand "
                "(e.g. with vi.flip_enum / categorical_enum sites)."
            )
        specs[addr] = tuple(leaf.shape)
    return specs


def advi(
    rng: torch.Generator | int,
    model,
    args: tuple,
    constraint: ChoiceMap,
    n_steps: int = 1000,
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    device: torch.device | str = "cuda",
):
    """Automatic mean-field VI: find the model's flat, real-valued latent
    addresses from a zero trace, build a Gaussian guide and fit the ELBO.
    Returns `(params, guide, make_target, grad_norms)`; posterior draws come
    from the fitted guide::

        params, guide, make_target, _ = advi(rng, model, args, obs)
        _, latents = guide.random_weighted(rng, make_target(params))
    """
    rng = as_generator(rng, device)
    specs = _discover_flat_latents(model, args, constraint)
    guide = mean_field_guide(specs)
    init = mean_field_init(specs, device)
    # The variational parameters ride in the target's arguments, so that
    # ADEV differentiates them; the model ignores the extra argument. The
    # objective takes the parameters' leaves (as the transform passes
    # them), and the target puts the dict back together.
    wrapped = model.contramap(lambda *a: a[:-1])
    leaves, spec = pytree.tree_flatten(init)

    def make_target(params):
        return Target(wrapped, (*args, params), constraint)

    def make_target_leafwise(*param_leaves):
        return make_target(pytree.tree_unflatten(list(param_leaves), spec))

    flat, gnorms = fit(rng, ELBO(guide, make_target_leafwise), tuple(leaves), n_steps, optimizer, device)
    return pytree.tree_unflatten(list(flat), spec), guide, make_target, gnorms


__all__ = [
    "ELBO",
    "IWELBO",
    "PWake",
    "QWake",
    "adev_distribution",
    "advi",
    "categorical_enum",
    "dirichlet_reparam",
    "fit",
    "flip_enum",
    "flip_mvd",
    "gamma_reparam",
    "geometric_reinforce",
    "mean_field_guide",
    "mean_field_init",
    "mv_normal_diag_reparam",
    "normal_reinforce",
    "normal_reparam",
]
