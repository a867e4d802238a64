from genjax_tpu_torch.distributions.distribution import (
    Distribution,
    DistributionTrace,
    ExactDensity,
    exact_density,
)
from genjax_tpu_torch.distributions.discrete_hmm import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
    forward_filtering_backward_sampling,
)
from genjax_tpu_torch.distributions.library import (
    bernoulli,
    beta,
    categorical,
    dirichlet,
    flip,
    gamma,
    geometric,
    mv_normal_diag,
    normal,
    uniform,
)

__all__ = [
    "DiscreteHMM",
    "DiscreteHMMConfiguration",
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "bernoulli",
    "beta",
    "categorical",
    "dirichlet",
    "exact_density",
    "flip",
    "gamma",
    "geometric",
    "forward_filtering_backward_sampling",
    "mv_normal_diag",
    "normal",
    "uniform",
]
