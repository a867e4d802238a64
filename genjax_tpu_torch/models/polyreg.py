"""Bayesian polynomial regression: importance sampling with MALA
rejuvenation.

Counterpart of `genjax_tpu/models/polyreg.py`. The body runs once on the
particle batch, so it writes `coeffs @ design.mT` (JAX: `design @ coeffs`
for one particle under `vmap`), right for `(3,)` and for `(K, 3)`.
"""

import dataclasses

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.distributions.library import mv_normal_diag, normal
from genjax_tpu_torch.inference.mcmc import mh, share_chain_args
from genjax_tpu_torch.inference.requests import MALA
from genjax_tpu_torch.inference.smc import ParticleCollection
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.lang.static import gen


@gen
def polynomial_regression(xs, obs_noise):
    coeffs = mv_normal_diag(xs.new_zeros(3), xs.new_ones(3)) @ "coeffs"
    design = torch.stack([torch.ones_like(xs), xs, xs**2], dim=-1)
    mean = coeffs @ design.mT
    _ = normal(mean, obs_noise * torch.ones_like(xs)) @ "ys"
    return mean


def simulate_polyreg_data(rng: torch.Generator, n_points: int, obs_noise: float):
    """(xs, ys) on the generator's device: `n_points` design points evenly
    spaced on [-2, 2], and `ys = 0.5 - xs + 0.3 xs^2` plus `obs_noise`
    times standard normal noise (the data of `bench.py:537-569`, there
    drawn from a JAX key)."""
    xs = torch.linspace(-2.0, 2.0, n_points, device=rng.device)
    design = torch.stack([torch.ones_like(xs), xs, xs**2], dim=-1)
    noise = torch.randn(n_points, generator=rng, device=rng.device)
    return xs, design @ torch.tensor([0.5, -1.0, 0.3], device=rng.device) + obs_noise * noise


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """IS + MALA as `bench.py:537-569` runs it (BASELINE config 2), the
    configuration of `chip_smoke.py` and `profiling.py`."""

    n_particles: int = 8192
    n_points: int = 64
    n_sweeps: int = 20
    step_size: float = 1e-3
    obs_noise: float = 0.3
    data_seed: int = 11

    def data(self, device: torch.device | str):
        """(xs, ys) drawn on the CPU from `data_seed`, then moved to
        `device`, so that every device sees the same data."""
        xs, ys = simulate_polyreg_data(torch.Generator().manual_seed(self.data_seed), self.n_points, self.obs_noise)
        return xs.to(device), ys.to(device)


def run_is_mh(
    rng: torch.Generator,
    xs,
    ys,
    n_particles: int = 1024,
    n_rejuvenation: int = 20,
    obs_noise: float = 0.3,
    step_size: float = 1e-3,
):
    """Importance-sample `n_particles` particles, take the LML estimate,
    resample once (systematic), then MALA-rejuvenate the coefficients
    `n_rejuvenation` times. Returns (LML estimate, coefficient draws).
    The LML and the resample each reduce the weights once through
    `ops.logsumexp`: two kernel launches on the device."""
    target = Target(polynomial_regression, (xs, obs_noise), ChoiceMap.kw(ys=ys))
    trs, ws = target.importance(rng, ChoiceMap.empty(), n=n_particles)
    collection = ParticleCollection(trs, ws)
    lml = collection.get_log_marginal_likelihood_estimate()
    collection = collection.resample(rng)
    particles = share_chain_args(collection.get_particles(), (xs, obs_noise))
    request = MALA(Selection.at["coeffs"], step_size)
    for _ in range(n_rejuvenation):
        particles, _ = mh(rng, particles, request)
    return lml, particles.get_choices()["coeffs"]
