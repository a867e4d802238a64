from genjax_tpu_torch.distributions.distribution import (
    Distribution,
    DistributionTrace,
    ExactDensity,
    exact_density,
)
from genjax_tpu_torch.distributions.library import beta, flip, normal, uniform

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "beta",
    "exact_density",
    "flip",
    "normal",
    "uniform",
]
