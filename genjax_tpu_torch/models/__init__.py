"""The model zoo: the BASELINE configurations and the application models,
under the JAX package's names (`genjax_tpu/models/__init__.py`)."""

from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli, run_sir
from genjax_tpu_torch.models.gmm import make_gmm, run_gibbs, simulate_gmm_data
from genjax_tpu_torch.models.gp import gp_posterior, make_gp_regression, matern32_kernel, rbf_kernel, run_gp_ess
from genjax_tpu_torch.models.hierarchical import (
    EIGHT_SCHOOLS_SIGMA,
    EIGHT_SCHOOLS_Y,
    eight_schools,
    eight_schools_centered,
    eight_schools_quadrature,
    run_eight_schools,
)
from genjax_tpu_torch.models.logreg import logistic_regression, run_hmc_chains, run_mala_chains
from genjax_tpu_torch.models.polyreg import polynomial_regression, run_is_mh
from genjax_tpu_torch.models.ssm import make_ssm_models, run_bootstrap_filter, simulate_ssm_data
from genjax_tpu_torch.models.stochvol import make_sv_filter, run_sv_pmmh, simulate_sv_data, sv_log_prior
from genjax_tpu_torch.models.sts import StructuralTimeSeries, ar, local_level, local_linear_trend, seasonal

__all__ = [
    "EIGHT_SCHOOLS_SIGMA",
    "EIGHT_SCHOOLS_Y",
    "StructuralTimeSeries",
    "ar",
    "beta_bernoulli",
    "eight_schools",
    "eight_schools_centered",
    "eight_schools_quadrature",
    "gp_posterior",
    "local_level",
    "local_linear_trend",
    "logistic_regression",
    "make_gmm",
    "make_gp_regression",
    "make_ssm_models",
    "make_sv_filter",
    "matern32_kernel",
    "polynomial_regression",
    "rbf_kernel",
    "run_bootstrap_filter",
    "run_eight_schools",
    "run_gibbs",
    "run_gp_ess",
    "run_hmc_chains",
    "run_is_mh",
    "run_mala_chains",
    "run_sir",
    "run_sv_pmmh",
    "seasonal",
    "simulate_gmm_data",
    "simulate_ssm_data",
    "simulate_sv_data",
    "sv_log_prior",
]
