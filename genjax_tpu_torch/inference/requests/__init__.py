from genjax_tpu_torch.inference.requests.drift import GaussianDrift
from genjax_tpu_torch.inference.requests.elliptical import EllipticalSlice, elliptical_slice
from genjax_tpu_torch.inference.requests.hmc import (
    HMC,
    MALA,
    SafeHMC,
    assess_momenta,
    make_selection_grad_fn,
    sample_momenta,
    selection_gradient,
)
from genjax_tpu_torch.inference.requests.nuts import NUTS, NUTSInfo, nuts_kernel, nuts_warmup
from genjax_tpu_torch.inference.requests.rejuvenate import Rejuvenate

__all__ = [
    "EllipticalSlice",
    "GaussianDrift",
    "HMC",
    "MALA",
    "NUTS",
    "NUTSInfo",
    "Rejuvenate",
    "SafeHMC",
    "assess_momenta",
    "elliptical_slice",
    "make_selection_grad_fn",
    "nuts_kernel",
    "nuts_warmup",
    "sample_momenta",
    "selection_gradient",
]
