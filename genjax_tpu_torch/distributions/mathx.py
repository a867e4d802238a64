"""Special-function helpers for the distribution library.

Counterpart of the parts of `jax.scipy.special` and
`genjax_tpu/distributions/mathx.py` that the library's densities use.
`xlogy` and `xlog1py` follow JAX's rule: the result is 0 wherever
`x == 0`, whatever `y` is (NaN included). A Python-number argument stays
a Python number, so no constant is copied to the device.
"""

import math

import torch

from genjax_tpu_torch.core.typing import DEFAULT_DTYPE, device_of


def log(x):
    """`log` of a Python number or a tensor."""
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def log1p(x):
    """`log1p` of a Python number or a tensor."""
    return torch.log1p(x) if isinstance(x, torch.Tensor) else math.log1p(x)


def _x_times(log_fn, x, y):
    if not isinstance(x, torch.Tensor):
        if x == 0:
            return torch.zeros_like(y) if isinstance(y, torch.Tensor) else 0.0
        return x * log_fn(y)
    nonzero = x != 0
    safe_y = torch.where(nonzero, y, 1.0)
    return torch.where(nonzero, x * log_fn(safe_y), 0.0)


def xlogy(x, y):
    """`x * log(y)`, 0 where `x == 0`."""
    return _x_times(log, x, y)


def xlog1py(x, y):
    """`x * log1p(y)`, 0 where `x == 0`."""
    return _x_times(log1p, x, y)


def gammaln(a):
    """`log Gamma(a)`; on the host for a Python number."""
    return torch.lgamma(a) if isinstance(a, torch.Tensor) else math.lgamma(a)


def betaln(a, b):
    """`log B(a, b)`; on the host when both are Python numbers."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        device = device_of(a, b)
        a = torch.as_tensor(a, dtype=DEFAULT_DTYPE, device=device)
        b = torch.as_tensor(b, dtype=DEFAULT_DTYPE, device=device)
        return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
