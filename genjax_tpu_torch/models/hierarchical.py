"""Hierarchical partial pooling (eight schools) with an exact quadrature
oracle.

Counterpart of `genjax_tpu/models/hierarchical.py`: `eight_schools`
(non-centered: latents `mu`, `log_tau`, `z`, with theta = mu + tau * z),
`eight_schools_centered` (latents `mu`, `log_tau`, `theta`: the funnel),
`HierarchicalOracle`, `eight_schools_quadrature` (the 2-D posterior of
`(mu, log_tau)` on a grid, with theta marginalized in closed form, so every
latent's posterior moments are exact to quadrature) and
`run_eight_schools`. `tau` is sampled in log space through
`exp_half_cauchy`. The bodies are written for a batch of chains: batch
axes in front, the schools' axis last.
"""

import math

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.distributions.library import exp_half_cauchy, mv_normal_diag, normal
from genjax_tpu_torch.lang.static import gen

__all__ = [
    "EIGHT_SCHOOLS_SIGMA",
    "EIGHT_SCHOOLS_Y",
    "HierarchicalOracle",
    "eight_schools",
    "eight_schools_centered",
    "eight_schools_quadrature",
    "run_eight_schools",
]

# Rubin (1981) SAT coaching data (on the CPU; the runners move them).
EIGHT_SCHOOLS_Y = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
EIGHT_SCHOOLS_SIGMA = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

MU_SCALE = 5.0
TAU_SCALE = 5.0


@gen
def eight_schools(sigma):
    """Non-centered: theta = mu + tau * z with z ~ N(0, I)."""
    j = sigma.shape[-1]
    mu = normal(0.0, MU_SCALE) @ "mu"
    log_tau = exp_half_cauchy(TAU_SCALE) @ "log_tau"
    z = mv_normal_diag(sigma.new_zeros(j), sigma.new_ones(j)) @ "z"
    theta = mu[..., None] + torch.exp(log_tau)[..., None] * z
    _ = mv_normal_diag(theta, sigma) @ "ys"
    return theta


@gen
def eight_schools_centered(sigma):
    """Centered: theta drawn directly (the funnel-pathology variant)."""
    j = sigma.shape[-1]
    mu = normal(0.0, MU_SCALE) @ "mu"
    log_tau = exp_half_cauchy(TAU_SCALE) @ "log_tau"
    ones = sigma.new_ones(j)
    theta = mv_normal_diag(mu[..., None] * ones, torch.exp(log_tau)[..., None] * ones) @ "theta"
    _ = mv_normal_diag(theta, sigma) @ "ys"
    return theta


@Pytree.dataclass
class HierarchicalOracle(Pytree):
    """Exact posterior moments from 2-D quadrature over (mu, log_tau)."""

    mu_mean: torch.Tensor
    mu_var: torch.Tensor
    tau_mean: torch.Tensor
    tau_var: torch.Tensor
    log_tau_mean: torch.Tensor
    theta_mean: torch.Tensor  # (J,)
    theta_var: torch.Tensor  # (J,)
    log_evidence: torch.Tensor


def eight_schools_quadrature(
    y,
    sigma,
    *,
    n_mu: int = 601,
    n_lt: int = 601,
    mu_span: float = 40.0,
    lt_lo: float = -12.0,
    lt_hi: float = 7.0,
) -> HierarchicalOracle:
    """Exact (to quadrature) posterior moments of the eight-schools model,
    either parameterization (they define the same joint), computed on
    `y`'s device in its dtype.

    Marginalizing theta: `y_j | mu, tau ~ N(mu, sigma_j^2 + tau^2)`, and
    `theta_j | mu, tau, y_j` is the precision-weighted Gaussian
    `N((y_j tau^2 + mu sigma_j^2) / (tau^2 + sigma_j^2),
    tau^2 sigma_j^2 / (tau^2 + sigma_j^2))`. The grid covers
    `mu in [-mu_span, mu_span]`, `log_tau in [lt_lo, lt_hi]`.

    >>> from genjax_tpu_torch.models.hierarchical import (
    ...     EIGHT_SCHOOLS_SIGMA, EIGHT_SCHOOLS_Y, eight_schools_quadrature)
    >>> o = eight_schools_quadrature(EIGHT_SCHOOLS_Y, EIGHT_SCHOOLS_SIGMA)
    >>> round(float(o.mu_mean), 1), o.theta_mean.shape
    (4.4, torch.Size([8]))
    """
    y = torch.as_tensor(y)
    sigma = torch.as_tensor(sigma, dtype=y.dtype, device=y.device)
    mus = torch.linspace(-mu_span, mu_span, n_mu, dtype=y.dtype, device=y.device)
    lts = torch.linspace(lt_lo, lt_hi, n_lt, dtype=y.dtype, device=y.device)
    mu_g, lt_g = torch.meshgrid(mus, lts, indexing="ij")
    tau2 = torch.exp(2.0 * lt_g)

    lp = normal.logpdf(mu_g, 0.0, MU_SCALE) + exp_half_cauchy.logpdf(lt_g, TAU_SCALE)
    var = tau2[..., None] + sigma**2
    resid2 = (y - mu_g[..., None]) ** 2
    lp = lp + (-0.5 * (torch.log(2.0 * math.pi * var) + resid2 / var)).sum(-1)

    dmu = mus[1] - mus[0]
    dlt = lts[1] - lts[0]
    lse = torch.logsumexp(lp.reshape(-1), 0)
    log_z = lse + torch.log(dmu * dlt)
    w = torch.exp(lp - lse)

    def mom(f):
        m1 = (w * f).sum()
        return m1, (w * f * f).sum() - m1 * m1

    mu_mean, mu_var = mom(mu_g)
    tau_mean, tau_var = mom(torch.exp(lt_g))
    lt_mean = (w * lt_g).sum()

    # The conditional moments of theta, mixed over the grid.
    s2 = sigma**2
    t2 = tau2[..., None]
    cond_m = (y * t2 + mu_g[..., None] * s2) / (t2 + s2)
    cond_v = t2 * s2 / (t2 + s2)
    th_mean = (w[..., None] * cond_m).sum((0, 1))
    th_m2 = (w[..., None] * (cond_v + cond_m * cond_m)).sum((0, 1))
    return HierarchicalOracle(
        mu_mean=mu_mean,
        mu_var=mu_var,
        tau_mean=tau_mean,
        tau_var=tau_var,
        log_tau_mean=lt_mean,
        theta_mean=th_mean,
        theta_var=th_m2 - th_mean * th_mean,
        log_evidence=log_z,
    )


def run_eight_schools(
    rng: torch.Generator,
    y=None,
    sigma=None,
    *,
    algorithm: str = "chees",
    n_chains: int = 64,
    n_warmup: int = 300,
    n_samples: int = 500,
    **kwargs,
):
    """Sample the non-centered posterior on the generator's device;
    returns the `PosteriorSamples` and the derived per-school theta draws,
    `(n_chains, n_samples, J)`. `y` and `sigma` default to Rubin's data.

    `log_tau` starts Uniform(-2, 2) per chain (Stan's convention) and not
    from its half-Cauchy prior, whose draws can start a chain at tau ~ e^7,
    where a globally adapted step size never moves it."""
    from genjax_tpu_torch.inference.sample import sample_posterior

    dev = rng.device
    y = (EIGHT_SCHOOLS_Y if y is None else torch.as_tensor(y)).to(dev)
    sigma = (EIGHT_SCHOOLS_SIGMA if sigma is None else torch.as_tensor(sigma)).to(dev)

    def init(r):
        return ChoiceMap.kw(log_tau=4.0 * torch.rand(n_chains, generator=r, device=dev) - 2.0)

    out = sample_posterior(
        rng,
        eight_schools,
        ChoiceMap.kw(ys=y),
        (sigma,),
        algorithm=algorithm,
        n_chains=n_chains,
        n_warmup=n_warmup,
        n_samples=n_samples,
        init=init,
        **kwargs,
    )
    mu = out.samples["mu"]
    tau = torch.exp(out.samples["log_tau"])
    theta = mu[..., None] + tau[..., None] * out.samples["z"]
    return out, theta
