"""BASELINE config 5: an ADEV-trained variational guide driving RAVI-style
nested SMC.

Counterpart of `genjax_tpu/models/ravi.py`. Train a reparameterized guide
by ELBO gradient descent (ADEV), then use it as the proposal of
`ImportanceK` at large K: the guide's quality shows as a lower-variance
LML estimate. `mu ~ N(0, 1)`, `y ~ N(mu, 0.5)`, `y = 2`: the posterior is
N(1.6, 0.2) and the exact LML is `log N(2; 0, sqrt(1.25))`.

The entry points run on the CUDA card unless the caller passes
`device="cpu"`; `rng` is a generator on that device or an int seed.
"""

import dataclasses
import math

import torch

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.typing import as_generator, on_device
from genjax_tpu_torch.distributions.library import normal
from genjax_tpu_torch.inference import vi
from genjax_tpu_torch.inference.smc import ImportanceK
from genjax_tpu_torch.inference.sp import Target, marginal
from genjax_tpu_torch.lang.static import gen


@gen
def model(_vmu, _vls):
    mu = normal(0.0, 1.0) @ "mu"
    _ = normal(mu, 0.5) @ "y"
    return mu


@marginal()
@gen
def guide(target):
    vmu, vls = target.args
    _ = vi.normal_reparam(vmu, torch.exp(vls)) @ "mu"


def make_target(vmu, vls, obs: float = 2.0) -> Target:
    return Target(model, (vmu, vls), ChoiceMap.kw(y=obs))


def exact_lml(obs: float = 2.0) -> float:
    """`log N(obs; 0, sqrt(1.25))`, the marginal of `y`."""
    return -0.5 * obs**2 / 1.25 - 0.5 * math.log(2.0 * math.pi * 1.25)


def _params(params, device) -> tuple:
    return tuple(on_device(p, device, torch.float32) for p in params)


def train_guide(
    rng: torch.Generator | int, n_steps: int = 300, lr: float = 2e-2, obs: float = 2.0, device: str = "cuda"
) -> tuple:
    """ELBO-train the guide's (mean, log-scale) from (0, 0) by plain
    gradient descent at rate `lr`; no host synchronisation per step.
    Returns the parameters as 0-d tensors on `device`."""
    rng = as_generator(rng, device)
    elbo_grad = vi.ELBO(guide, lambda vmu, vls: make_target(vmu, vls, obs))
    params = _params((0.0, 0.0), device)
    for _ in range(n_steps):
        grads = elbo_grad(rng, params)
        params = tuple(p - lr * g for p, g in zip(params, grads))
    return params


def nested_smc_lml(
    rng: torch.Generator | int, params, k_particles: int, obs: float = 2.0, device: str = "cuda"
) -> torch.Tensor:
    """The LML estimate with the trained guide as the SIR proposal (one
    launch of the logsumexp kernel on the card)."""
    rng = as_generator(rng, device)
    target = make_target(*_params(params, device), obs=obs)
    return ImportanceK(target, q=guide, k_particles=k_particles).estimate_normalizing_constant(rng, target)


def run_ravi(
    rng: torch.Generator | int,
    n_train: int = 300,
    k_particles: int = 100_000,
    obs: float = 2.0,
    device: str = "cuda",
):
    """The whole pipeline: `(params, guided LML, prior-proposal LML, exact
    LML)`."""
    k1, k2, k3 = fork(as_generator(rng, device), 3)
    params = train_guide(k1, n_steps=n_train, obs=obs, device=device)
    lml_guided = nested_smc_lml(k2, params, k_particles, obs, device)
    target = make_target(*params, obs=obs)
    lml_prior = ImportanceK(target, k_particles=k_particles).estimate_normalizing_constant(k3, target)
    return params, lml_guided, lml_prior, exact_lml(obs)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """Config 5 at the width of `bench.py::_ravi` (:573-603): 150 ELBO
    steps at 2e-2, 20 guided LML estimates at K = 1,000,000; and one IWELBO
    gradient at N = 1,000,000 (the logsumexp kernel forward and backward at
    full width)."""

    n_train: int = 150
    lr: float = 2e-2
    k_particles: int = 1_000_000
    n_estimates: int = 20
    iwelbo_particles: int = 1_000_000
    obs: float = 2.0
