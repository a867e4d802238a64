"""Particle marginal Metropolis-Hastings (PMMH).

Counterpart of `genjax_tpu/inference/pmmh.py`. PMMH (Andrieu, Doucet &
Holenstein 2010) targets the posterior over a state-space model's
PARAMETERS with MH whose likelihood is the bootstrap filter's unbiased
marginal-likelihood estimate: the pseudo-marginal chain's stationary law
is the exact parameter posterior, for any particle count.

JAX's outer `lax.scan` over MH steps is a Python loop here; each step
re-runs `BootstrapFilter.run` at the proposed parameters (`model_args=`),
and the accept is a select on the device (no host read beyond the
filter's own ESS gate).
"""

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.inference.particle_filter import BootstrapFilter

__all__ = ["PMMH"]


def _walk(rng: torch.Generator, theta: Any, scales: Any) -> Any:
    """A Gaussian random-walk proposal, one draw per leaf (symmetric, so
    the proposal density cancels in the acceptance ratio)."""

    def step(v, s):
        v = torch.as_tensor(v, device=rng.device, dtype=torch.float32) if not isinstance(v, torch.Tensor) else v
        return v + s * torch.randn(v.shape, generator=rng, device=v.device, dtype=v.dtype)

    return pytree.tree_map(step, theta, scales)


def _broadcast_scales(scales: Any, theta: Any) -> Any:
    """A scale tree matching `theta`: given as one, or one value for every
    parameter leaf."""
    if pytree.tree_structure(scales) == pytree.tree_structure(theta):
        return scales
    return pytree.tree_map(lambda _: scales, theta)


def _select(accept: torch.Tensor, new: Any, old: Any) -> Any:
    return pytree.tree_map(lambda a, b: torch.where(accept, a, b), new, old)


@Pytree.dataclass
class PMMH(Pytree):
    """MH over state-space-model parameters with a particle-filter
    likelihood estimate (the exact pseudo-marginal target).

    The filter's models take the parameters as one more trailing argument:
    `init_model(theta)` and `step_model(z_prev, t, theta)` (`theta` any
    pytree). `log_prior(theta)` scores the parameter prior; `step_scales`
    is the random-walk scale (a number or a tree matching `theta`).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.pmmh import PMMH
    >>> @gx.gen
    ... def init_model(theta):
    ...     z = gx.normal(0.0, 1.0) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> @gx.gen
    ... def step_model(z_prev, t, theta):
    ...     z = gx.normal(theta * z_prev, 0.5) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> pf = gx.BootstrapFilter(step_model, init_model, 256, obs_addr="y")
    >>> alg = PMMH(pf, log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0), step_scales=0.2)
    >>> ys = torch.tensor([0.3, 1.0, 0.5, -0.2, 0.8])
    >>> theta, (thetas, lmls, accepts) = alg.run(torch.Generator().manual_seed(0), torch.tensor(0.5), ys, n_steps=10)
    >>> thetas.shape, bool(torch.isfinite(lmls).all())
    (torch.Size([10]), True)
    """

    filter: BootstrapFilter
    log_prior: Callable[[Any], Any] = Pytree.static()
    step_scales: Any = 0.25

    def run(
        self,
        rng: torch.Generator,
        theta0: Any,
        observations: Any,
        n_steps: int,
        collect: Callable[[Any], Any] | None = None,
    ):
        """Run the chain from `theta0`. Returns `(final_theta, (collected,
        lmls, accepts))`, each stacked along a leading step axis:
        `collect(theta)` after each step (`theta` itself by default), the
        carried marginal-likelihood estimates, the accept flags.

        Pseudo-marginal discipline: the LML estimate of the CURRENT
        parameters is carried, never re-estimated (re-running the filter
        for a held value would bias the chain)."""
        scales = _broadcast_scales(self.step_scales, theta0)
        theta = theta0
        lml, _ = self.filter.run(rng, observations, (theta,))
        lp = self.log_prior(theta)
        outs, lmls, accepts = [], [], []
        for _ in range(n_steps):
            theta_p = _walk(rng, theta, scales)
            lml_p, _ = self.filter.run(rng, observations, (theta_p,))
            lp_p = self.log_prior(theta_p)
            alpha = lml_p + lp_p - lml - lp
            accept = torch.log(torch.rand((), generator=rng, device=rng.device)) < alpha
            theta = _select(accept, theta_p, theta)
            lml = torch.where(accept, lml_p, lml)
            lp = torch.where(accept, lp_p, lp)
            outs.append(theta if collect is None else collect(theta))
            lmls.append(lml)
            accepts.append(accept)
        stack = lambda xs: pytree.tree_map(lambda *v: torch.stack(v), *xs)  # noqa: E731
        return theta, (stack(outs), torch.stack(lmls), torch.stack(accepts))
