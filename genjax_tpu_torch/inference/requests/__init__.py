from genjax_tpu_torch.inference.requests.hmc import (
    HMC,
    MALA,
    assess_momenta,
    make_selection_grad_fn,
    sample_momenta,
    selection_gradient,
)

__all__ = [
    "HMC",
    "MALA",
    "assess_momenta",
    "make_selection_grad_fn",
    "sample_momenta",
    "selection_gradient",
]
