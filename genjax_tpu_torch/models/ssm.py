"""Nonlinear state-space model, filtered by the bootstrap particle filter.

Counterpart of `genjax_tpu/models/ssm.py`:
`z_t = a z_{t-1} + 0.5 sin(z_{t-1}) + eps`, `y_t = z_t + nu` (observed).
"""

import torch

from genjax_tpu_torch.distributions.library import normal
from genjax_tpu_torch.inference.particle_filter import BootstrapFilter
from genjax_tpu_torch.lang.static import gen


def make_ssm_models(trans_coef: float = 0.9, trans_noise: float = 0.5, obs_noise: float = 0.4):
    @gen
    def init_model():
        z = normal(0.0, 1.0) @ "z"
        _ = normal(z, obs_noise) @ "y"
        return z

    @gen
    def step_model(z_prev, _t):
        drift = trans_coef * z_prev + 0.5 * torch.sin(z_prev)
        z = normal(drift, trans_noise) @ "z"
        _ = normal(z, obs_noise) @ "y"
        return z

    return init_model, step_model


def simulate_ssm_data(rng: torch.Generator, T: int, **kwargs) -> tuple[torch.Tensor, torch.Tensor]:
    """A ground-truth (latents, observations) pair of length-`T` vectors on
    the generator's device."""
    init_model, step_model = make_ssm_models(**kwargs)
    tr = init_model.simulate(rng, ())
    zs, ys = [tr.get_retval()], [tr.get_choices()["y"]]
    for _ in range(T - 1):
        tr = step_model.simulate(rng, (zs[-1], 0))
        zs.append(tr.get_retval())
        ys.append(tr.get_choices()["y"])
    return torch.stack(zs), torch.stack(ys)


def run_bootstrap_filter(
    rng: torch.Generator,
    observations: torch.Tensor,
    n_particles: int = 10_000,
    resampling: str = "systematic",
    **kwargs,
):
    """Particle-filter the observation sequence with the named resampler
    (`smc.RESAMPLERS`); returns (LML, final z)."""
    init_model, step_model = make_ssm_models(**kwargs)
    pf = BootstrapFilter(step_model, init_model, n_particles, obs_addr="y", resampling=resampling)
    return pf.run(rng, observations)
