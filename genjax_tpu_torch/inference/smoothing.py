"""Particle smoothing: forward-filter backward-sample (FFBS) over stored
particle clouds.

Counterpart of `genjax_tpu/inference/smoothing.py`: a generic particle
smoother for any `BootstrapFilter` model (Godsill, Doucet & West 2004).
The filter runs once storing its clouds and weights (`collect=`); the
backward pass reweights each step's cloud by the transition density to
the already chosen next state,

    P(pick particle i at t) ~ w_t^i * f(z_{t+1}^chosen | z_t^i).

JAX's reverse `lax.scan` is a loop over T here, and its inner `vmap` over
M trajectories one batch axis: each step scores the M x K pairs with one
`assess` of the step model over M*K particles (`backward_logits`), then
draws one index per trajectory on the device.
"""

from typing import Any

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.pytree import tree_map
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.particle_filter import BootstrapFilter, _at
from genjax_tpu_torch.inference.particle_gibbs import categorical_draw
from genjax_tpu_torch.inference.smc import multinomial_resample

__all__ = ["backward_logits", "ffbs_sample", "smoothing_clouds"]


def smoothing_clouds(filter: BootstrapFilter, rng: torch.Generator, observations: Any, model_args: tuple = ()):
    """Run the filter storing every step's cloud; returns `(lml, clouds (T,
    K, ...), log_weights (T, K))`, the inputs of `ffbs_sample`."""
    lml, _, (clouds, lws) = filter.run(rng, observations, model_args, collect=lambda z, lw: (z, lw))
    return lml, clouds, lws


def backward_logits(
    filter: BootstrapFilter,
    cloud_t: Any,
    log_weights_t: torch.Tensor,
    z_next: Any,
    y_next: Any,
    t: int,
    model_args: tuple = (),
    latent_addr: str = "z",
) -> torch.Tensor:
    """The backward kernel's logits at step `t`, `(M, K)`: row m is
    `log_weights_t + log f(z_next[m] | cloud_t) + log g(y_next | z_next[m])`,
    the step model's `assess` of trajectory m's next state `z_next` (leaves
    `(M, ...)`) from every member of the cloud `cloud_t` (leaves `(K, ...)`)
    at step `t + 1`. The observation term is the same across a row and
    cancels in the draw. One `assess` over M*K particles: row m*K + i pairs
    `z_next[m]` with `cloud_t[i]`."""
    K = log_weights_t.shape[0]
    M = pytree.tree_leaves(z_next)[0].shape[0]
    pairs_next = tree_map(lambda v: v.repeat_interleave(K, dim=0), z_next)
    pairs_prev = tree_map(lambda v: v.repeat((M,) + (1,) * (v.dim() - 1)), cloud_t)
    scores, _ = filter.step_model.assess(
        ChoiceMap.kw(**{latent_addr: per_particle(pairs_next), filter.obs_addr: y_next}),
        (tree_map(per_particle, pairs_prev), t + 1, *tuple(model_args)),
        M * K,
    )
    return log_weights_t + scores.reshape(M, K)


def ffbs_sample(
    rng: torch.Generator,
    filter: BootstrapFilter,
    clouds: Any,
    log_weights: torch.Tensor,
    n_paths: int,
    observations: Any,
    model_args: tuple = (),
    latent_addr: str = "z",
):
    """Draw `n_paths` smoothed trajectories from stored filtering clouds;
    returns leaves with leading axes `(n_paths, T)`.

    `clouds` and `log_weights` come from `smoothing_clouds`;
    `observations` is the sequence the filter ran on. The step model's
    return value must be the choice at `latent_addr`, and the observation
    density may depend on the new latent only (its term is then the same
    for every cloud member and cancels in the backward draw). Transitions
    are scored against the true observations, so the observation term is
    finite for any observation support."""
    T = pytree.tree_leaves(clouds)[0].shape[0]
    idx = multinomial_resample(rng, log_weights[-1], n_paths)  # n_paths i.i.d. draws from the last weights
    z_next = tree_map(lambda v: v[-1].index_select(0, idx), clouds)
    path = [z_next]
    for t in range(T - 2, -1, -1):
        cloud_t = _at(clouds, t)
        logits = backward_logits(
            filter, cloud_t, log_weights[t], z_next, _at(observations, t + 1), t, model_args, latent_addr
        )
        idx = categorical_draw(rng, logits)
        z_next = tree_map(lambda v: v.index_select(0, idx), cloud_t)
        path.append(z_next)
    path.reverse()
    return pytree.tree_map(lambda *v: torch.stack(v, dim=1), *path)
