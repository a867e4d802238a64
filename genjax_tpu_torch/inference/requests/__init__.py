from genjax_tpu_torch.inference.requests.drift import GaussianDrift
from genjax_tpu_torch.inference.requests.hmc import (
    HMC,
    MALA,
    assess_momenta,
    make_selection_grad_fn,
    sample_momenta,
    selection_gradient,
)
from genjax_tpu_torch.inference.requests.rejuvenate import Rejuvenate

__all__ = [
    "GaussianDrift",
    "HMC",
    "MALA",
    "Rejuvenate",
    "assess_momenta",
    "make_selection_grad_fn",
    "sample_momenta",
    "selection_gradient",
]
