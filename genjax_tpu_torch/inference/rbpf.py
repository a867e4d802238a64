"""Rao-Blackwellized particle filter for conditionally linear state-space
models.

Counterpart of `genjax_tpu/inference/rbpf.py::RaoBlackwellFilter`. For
models whose latent splits into a nonlinear regime process `z` and a
linear-Gaussian substate `x` given the z-path,

    z_t ~ f(z | z_{t-1})                     (any @gen kernel)
    x_t = A(z_t) x_{t-1} + N(0, Q(z_t))
    y_t = H(z_t) x_t     + N(0, R(z_t)),

the x-marginal is exactly Gaussian per z-path, so each particle carries
`(z, mu, P)` and its weight increment is the Kalman innovation likelihood
(Doucet, de Freitas, Murphy & Russell 2000).

JAX `vmap`s the per-particle pieces and scans the time steps. Here each
step is one batched `simulate` of the z-kernel over the K particles, the
matrices of every particle from `lgss_of_z` under `torch.func.vmap`, and
one batched `kalman_predict_update` over `(K, d, d)`. The ESS gate (JAX's
`lax.cond`) is a host `if`, as in `BootstrapFilter`: one device
synchronisation per step, after one `ops.logsumexp_ess` launch that gives
the gate, the LML increment and the resampler's normalizer.
"""

import math
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.gfi import GenerativeFunction
from genjax_tpu_torch.core.pytree import Pytree, tree_map
from genjax_tpu_torch.core.typing import FloatArray, per_particle, plain
from genjax_tpu_torch.inference.kalman import LinearGaussianSSM, kalman_predict_update
from genjax_tpu_torch.inference.smc import RESAMPLERS
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess

__all__ = ["RaoBlackwellFilter"]


def _rows(tree, idx: torch.Tensor):
    return tree_map(lambda v: v.index_select(0, idx), tree)


@Pytree.dataclass
class RaoBlackwellFilter(Pytree):
    """`z_init(*model_args)` / `z_step(z_prev, t, *model_args)` are @gen
    kernels over the nonlinear state (their retval is the new `z`; they
    trace no observation: the observation density comes from the Kalman
    step). `lgss_of_z(z, *model_args) -> LinearGaussianSSM` gives one
    particle's linear-substate matrices for its regime `z` (only `A`, `Q`,
    `H`, `R` are read per step; `mu0`, `P0` seed the t=0 update); it is
    called under `torch.func.vmap` over the particles, as JAX `vmap`s it,
    so it is written for one particle.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.kalman import LinearGaussianSSM
    >>> from genjax_tpu_torch.inference.rbpf import RaoBlackwellFilter
    >>> @gx.gen
    ... def z_init():
    ...     return gx.normal(0.0, 1.0) @ "z"
    >>> @gx.gen
    ... def z_step(z_prev, t):
    ...     return gx.normal(0.9 * z_prev, 0.3) @ "z"
    >>> m = LinearGaussianSSM.build(a=0.9, q=0.5, h=1.0, r=0.4, d=1, device="cpu")
    >>> ys = torch.tensor([[0.3], [1.0], [0.5], [-0.2]])
    >>> lml, (z, mu, P) = RaoBlackwellFilter(z_step, z_init, lambda z: m, 64).run(torch.Generator().manual_seed(0), ys)
    >>> abs(float(lml) - float(m.lml(ys))) < 1e-4, mu.shape, P.shape
    (True, torch.Size([64, 1]), torch.Size([64, 1, 1]))
    """

    z_step: GenerativeFunction[Any]
    z_init: GenerativeFunction[Any]
    lgss_of_z: Callable[..., LinearGaussianSSM] = Pytree.static()
    n_particles: int = Pytree.static()
    resampling: str = Pytree.static(default="systematic")
    ess_threshold: float = Pytree.static(default=0.5)

    def models(self, z, model_args: tuple = ()) -> LinearGaussianSSM:
        """Every particle's matrices, `(K, ...)` per field: `lgss_of_z` of
        one particle under `torch.func.vmap` over the particle axis."""
        return torch.func.vmap(lambda zi: self.lgss_of_z(zi, *model_args))(tree_map(plain, z))

    def kalman_step(self, z, mu, P, y, model_args: tuple = (), predict: bool = True):
        """One Kalman step of every particle under its own regime `z`:
        `(mu', P', log p(y | past, z-path))`, each with the particle axis."""
        m = self.models(z, model_args)
        return kalman_predict_update(m.A, m.Q, m.H, m.R, mu, P, y, predict=predict)

    def init(self, rng: torch.Generator, y0, model_args: tuple = ()):
        """The particles after the t=0 update: `(z, mu, P, lw)`."""
        z = self.z_init.simulate(rng, tuple(model_args), self.n_particles).get_retval()
        m = self.models(z, model_args)
        mu, P, lw = kalman_predict_update(m.A, m.Q, m.H, m.R, m.mu0, m.P0, y0, predict=False)
        return z, mu, P, lw

    def step(self, rng: torch.Generator, z, mu, P, lw, y_t, t: int, model_args: tuple = ()):
        """One filter step from the particles after time `t - 1`: the ESS
        gate, a resample where it fires, the z-kernel, the Kalman update on
        `y_t`. Returns `(z, mu, P, lw, banked)`, `banked` the evidence a
        resample banked (`logsumexp(lw) - log K`, else 0). The weights are
        reduced once (`ops.logsumexp_ess`, one launch), and the gate is a host
        branch: one synchronisation."""
        n = self.n_particles
        lse, ess = logsumexp_ess(lw)
        banked = torch.zeros((), device=lw.device)
        if ess < self.ess_threshold * n:
            banked = lse - math.log(n)
            z, mu, P = _rows((z, mu, P), RESAMPLERS[self.resampling](rng, lw, n, lse))
            lw = torch.zeros_like(lw)
        z = self.z_step.simulate(rng, (tree_map(per_particle, z), t, *model_args), n).get_retval()
        mu, P, ll = self.kalman_step(z, mu, P, y_t, model_args, predict=True)
        return z, mu, P, lw + ll, banked

    def run(self, rng: torch.Generator, observations: FloatArray, model_args: tuple = ()) -> tuple[FloatArray, Any]:
        """Filter `observations` (T, p), on the generator's device; returns
        `(lml_estimate, (z_particles, mu_particles, P_particles))`, equally
        weighted after a final resample, as `BootstrapFilter.run`."""
        n = self.n_particles
        model_args = tuple(model_args)
        z, mu, P, lw = self.init(rng, tree_map(lambda v: v[0], observations), model_args)
        lml = torch.zeros((), device=lw.device)
        for t in range(1, pytree.tree_leaves(observations)[0].shape[0]):
            z, mu, P, lw, banked = self.step(rng, z, mu, P, lw, tree_map(lambda v: v[t], observations), t, model_args)
            lml = lml + banked
        lse = logsumexp(lw)
        lml = lml + lse - math.log(n)
        z, mu, P = _rows((z, mu, P), RESAMPLERS[self.resampling](rng, lw, n, lse))
        return lml, tree_map(plain, (z, mu, P))
