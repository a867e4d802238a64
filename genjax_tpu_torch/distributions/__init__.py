from genjax_tpu_torch.distributions.distribution import (
    Distribution,
    DistributionTrace,
    ExactDensity,
    exact_density,
)
from genjax_tpu_torch.distributions.library import (
    bernoulli,
    beta,
    flip,
    mv_normal_diag,
    normal,
    uniform,
)

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "bernoulli",
    "beta",
    "exact_density",
    "flip",
    "mv_normal_diag",
    "normal",
    "uniform",
]
