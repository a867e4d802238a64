"""Gaussian process models: kernels, a GP-regression generative function,
and a latent-GP driver under elliptical slice sampling.

Counterpart of `genjax_tpu/models/gp.py`: `rbf_kernel`,
`matern32_kernel`, `make_gp_regression`, `gp_posterior` (the conjugate
posterior mean, covariance and log marginal likelihood: the oracle) and
`run_gp_ess`. The latent values carry one correlated Gaussian prior (an
`mv_normal` site), which is what `EllipticalSlice` needs.
"""

import math
from typing import Any

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.gfi import GenerativeFunction
from genjax_tpu_torch.lang.static import gen

__all__ = ["rbf_kernel", "matern32_kernel", "make_gp_regression", "gp_posterior", "run_gp_ess"]


def _sqdist(xs: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances; inputs (n,) or (n, d). Direct
    differences, not the x2 + z2 - 2 x.z product, whose cancellation can
    make near-zero distances negative."""
    xs = xs[:, None] if xs.dim() == 1 else xs
    zs = zs[:, None] if zs.dim() == 1 else zs
    diff = xs[:, None, :] - zs[None, :, :]
    return (diff * diff).sum(-1)


def rbf_kernel(xs, zs, lengthscale=1.0, variance=1.0):
    """Squared-exponential kernel matrix k(xs, zs).

    >>> import torch
    >>> from genjax_tpu_torch.models.gp import rbf_kernel
    >>> K = rbf_kernel(torch.linspace(0.0, 1.0, 4), torch.linspace(0.0, 1.0, 4))
    >>> K.shape, bool(torch.allclose(K.diagonal(), torch.ones(4)))
    (torch.Size([4, 4]), True)
    """
    return variance * torch.exp(-0.5 * _sqdist(xs, zs) / lengthscale**2)


def matern32_kernel(xs, zs, lengthscale=1.0, variance=1.0):
    """Matern-3/2 kernel matrix."""
    r = torch.sqrt(_sqdist(xs, zs)) / lengthscale
    s3r = math.sqrt(3.0) * r
    return variance * (1.0 + s3r) * torch.exp(-s3r)


def make_gp_regression(kernel=rbf_kernel, jitter: float = 1e-5) -> GenerativeFunction[Any]:
    """GP regression as a generative function: latent values
    `f ~ N(0, K(xs, xs))` at "f", observations `y ~ N(f, obs_noise)` at
    "y". Arguments: `(xs, obs_noise, lengthscale, variance)`."""
    from genjax_tpu_torch.distributions.library import mv_normal, normal

    @gen
    def gp_regression(xs, obs_noise, lengthscale, variance):
        n = xs.shape[0]
        K = kernel(xs, xs, lengthscale, variance) + jitter * torch.eye(n, dtype=xs.dtype, device=xs.device)
        f = mv_normal(xs.new_zeros(n), K) @ "f"
        _ = normal(f, obs_noise * xs.new_ones(n)) @ "y"
        return f

    return gp_regression


def gp_posterior(xs, ys, obs_noise, lengthscale=1.0, variance=1.0, kernel=rbf_kernel):
    """The exact conjugate GP-regression posterior over f(xs): returns
    `(mean, cov, lml)`."""
    n = xs.shape[0]
    K = kernel(xs, xs, lengthscale, variance)
    S = K + obs_noise**2 * torch.eye(n, dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky(S)
    alpha = torch.cholesky_solve(ys[:, None], L)[:, 0]
    mean = K @ alpha
    cov = K - K @ torch.cholesky_solve(K, L)
    lml = -0.5 * ys @ alpha - torch.log(torch.diagonal(L)).sum() - 0.5 * n * math.log(2.0 * math.pi)
    return mean, cov, lml


def run_gp_ess(
    rng: torch.Generator,
    xs: torch.Tensor,
    ys: torch.Tensor,
    n_steps: int = 2000,
    obs_noise: float = 0.3,
    lengthscale: float = 1.0,
    variance: float = 1.0,
    kernel=rbf_kernel,
):
    """Sample the latent GP with elliptical slice sampling (the correlated
    prior draw comes from the model's own `mv_normal` site through
    `Regenerate`). Returns the `(n_steps, n)` chain of latent values."""
    from genjax_tpu_torch.inference.mcmc import mh_chain
    from genjax_tpu_torch.inference.requests import EllipticalSlice

    model = make_gp_regression(kernel)
    args = (xs, obs_noise, lengthscale, variance)
    tr, _ = model.importance(rng, ChoiceMap.kw(y=ys), args)
    req = EllipticalSlice(Selection.at["f"], mean=0.0)
    _, fs = mh_chain(rng, tr, req, n_steps, collect=lambda t: t.get_choices()["f"])
    return fs
