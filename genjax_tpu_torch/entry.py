"""The flagship forward step: one bootstrap-particle-filter sweep over the
nonlinear SSM at K=4096 particles and T=20 steps.

Counterpart of `__graft_entry__.py::entry`. The observations are simulated
from a CPU generator seeded with 1 and then moved to `device`, so the
filter sees the same data on every device.
"""

import torch

from genjax_tpu_torch.models.ssm import run_bootstrap_filter, simulate_ssm_data

N_PARTICLES = 4096
N_STEPS = 20


def entry(device: torch.device | str = "cuda"):
    """Returns (fn, example_args): `fn(rng)` filters the observations and
    returns (LML estimate, mean of the final states). Runs on the CUDA card
    unless `device` says otherwise; without a card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(): no CUDA device; pass device='cpu' to run on the CPU.")
    _, ys = simulate_ssm_data(torch.Generator().manual_seed(1), N_STEPS)
    ys = ys.to(device)

    def fn(rng: torch.Generator):
        lml, z_final = run_bootstrap_filter(rng, ys, n_particles=N_PARTICLES)
        return lml, z_final.mean()

    return fn, (torch.Generator(device=device).manual_seed(0),)
