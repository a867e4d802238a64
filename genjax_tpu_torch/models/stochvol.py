"""Stochastic volatility: the canonical particle-MCMC model family.

Counterpart of `genjax_tpu/models/stochvol.py`. The latent log-volatility
path makes the parameter likelihood intractable, the pseudo-marginal case
PMMH and particle Gibbs were made for (Andrieu, Doucet & Holenstein 2010,
section 5.2). With theta = {"phi", "log_sigma", "log_beta"} (unconstrained;
tanh and exp inside the model):

    h_0 ~ N(0, sigma^2 / (1 - phi^2))        (stationary start)
    h_t ~ N(phi h_{t-1}, sigma^2)
    y_t ~ N(0, beta^2 exp(h_t))              (returns, mean zero)

JAX's data loop is a `lax.scan`; here it is a Python loop. The filter is
the port's `BootstrapFilter`, whose every step reduces its weights with
one launch of the logsumexp kernel on the card. The entry points run on
the CUDA card unless the caller passes `device="cpu"`; `rng` is a
generator on that device or an int seed.
"""

import dataclasses
import math

import torch

from genjax_tpu_torch.core.typing import as_generator, on_device
from genjax_tpu_torch.distributions.library import normal
from genjax_tpu_torch.inference.particle_filter import BootstrapFilter
from genjax_tpu_torch.inference.pmmh import PMMH
from genjax_tpu_torch.lang.static import gen


def _unpack(theta):
    phi = torch.tanh(theta["phi"])  # |phi| < 1: stationary
    return phi, torch.exp(theta["log_sigma"]), torch.exp(theta["log_beta"])


@gen
def sv_init(theta):
    phi, sigma, beta = _unpack(theta)
    h = normal(0.0, sigma / torch.sqrt(1.0 - phi**2)) @ "z"
    _ = normal(0.0, beta * torch.exp(0.5 * h)) @ "y"
    return h


@gen
def sv_step(h_prev, _t, theta):
    phi, sigma, beta = _unpack(theta)
    h = normal(phi * h_prev, sigma) @ "z"
    _ = normal(0.0, beta * torch.exp(0.5 * h)) @ "y"
    return h


def sv_log_prior(theta):
    """A weakly informative prior on the unconstrained parameters."""
    return (
        normal.logpdf(theta["phi"], 1.0, 1.0)  # tanh(1) ~ 0.76 persistence
        + normal.logpdf(theta["log_sigma"], -1.0, 1.0)
        + normal.logpdf(theta["log_beta"], 0.0, 1.0)
    )


def sv_theta(phi: float, log_sigma: float, log_beta: float, device: torch.device | str = "cuda") -> dict:
    """A parameter dict of 0-d float32 tensors on `device`."""
    return {k: on_device(float(v), device, torch.float32) for k, v in
            (("phi", phi), ("log_sigma", log_sigma), ("log_beta", log_beta))}


def true_theta(device: torch.device | str = "cuda") -> dict:
    """The JAX tests' ground truth: persistence 0.9, volatility 0.3,
    return scale 0.8."""
    return sv_theta(math.atanh(0.9), math.log(0.3), math.log(0.8), device)


def simulate_sv_data(rng: torch.Generator | int, T: int, theta: dict, device: torch.device | str = "cuda"):
    """Ground truth under `theta`: the log-volatility path and the returns,
    each `(T,)` on `device`."""
    rng = as_generator(rng, device)
    tr = sv_init.simulate(rng, (theta,))
    hs, ys = [tr.get_retval()], [tr.get_choices()["y"]]
    for t in range(1, T):
        tr = sv_step.simulate(rng, (hs[-1], t, theta))
        hs.append(tr.get_retval())
        ys.append(tr.get_choices()["y"])
    return torch.stack(hs), torch.stack(ys)


def make_sv_filter(n_particles: int = 1024, **kwargs) -> BootstrapFilter:
    return BootstrapFilter(sv_step, sv_init, n_particles, obs_addr="y", **kwargs)


def run_sv_pmmh(
    rng: torch.Generator | int,
    observations: torch.Tensor,
    theta0: dict | None = None,
    n_particles: int = 1024,
    n_steps: int = 500,
    step_scales=0.08,
    device: torch.device | str = "cuda",
):
    """PMMH over the SV parameters: `(final theta, theta chain, LML chain,
    accept flags)`, the chains stacked along a leading step axis."""
    rng = as_generator(rng, device)
    if theta0 is None:
        theta0 = sv_theta(1.0, -1.0, 0.0, device)
    alg = PMMH(make_sv_filter(n_particles), log_prior=sv_log_prior, step_scales=step_scales)
    theta, (thetas, lmls, accepts) = alg.run(rng, theta0, observations.to(device), n_steps=n_steps)
    return theta, thetas, lmls, accepts


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """The model's default width: 1024 particles over T=200 returns drawn
    at `true_theta`. SV0 runs 20 filters at the truth; SV1 100 PMMH steps
    (cut from the default 500 to fit a smoke run)."""

    n_particles: int = 1024
    T: int = 200
    n_filters: int = 20
    pmmh_steps: int = 100
    data_seed: int = 0

    def data(self, device: torch.device | str) -> torch.Tensor:
        """The returns `(T,)`: simulated on the CPU from `data_seed`, then
        moved to `device`, so that every device sees the same data."""
        _, ys = simulate_sv_data(self.data_seed, self.T, true_theta("cpu"), "cpu")
        return ys.to(device)
