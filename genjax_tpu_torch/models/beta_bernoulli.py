"""Beta-bernoulli SIR: `p ~ Beta(a, b)`, `v ~ Bernoulli(p)`.

Counterpart of `genjax_tpu/models/beta_bernoulli.py`. With `v = True`
observed and `a = b = 2`, the posterior is Beta(3, 2) (mean 0.6) and the
marginal likelihood is 0.5.
"""

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.distributions.library import beta, flip
from genjax_tpu_torch.inference.smc import ImportanceK
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.lang.static import gen


@gen
def beta_bernoulli(alpha, beta_param):
    p = beta(alpha, beta_param) @ "p"
    v = flip(p) @ "v"
    return v


def run_sir(rng: torch.Generator, obs: bool, k_particles: int = 50, n_trials: int = 50) -> torch.Tensor:
    """SIR posterior-mean estimate of `p`: the mean over `n_trials` of one
    resampled particle's `p`, each trial over `k_particles` particles."""
    target = Target(beta_bernoulli, (2.0, 2.0), ChoiceMap.d({"v": obs}))
    alg = ImportanceK(target, k_particles=k_particles)
    draws = [alg.random_weighted(rng, target)[1]["p"] for _ in range(n_trials)]
    return torch.stack(draws).mean()
