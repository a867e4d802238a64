"""MCMC convergence diagnostics: split R-hat and autocorrelation ESS.

Counterpart of `genjax_tpu/inference/diagnostics.py`: `split_rhat` and
`effective_sample_size`, the moment-based forms of Vehtari, Gelman,
Simpson, Carpenter & Buerkner (2021). Inputs have leading axes
`(n_chains, n_steps, ...)` (a tensor, or a pytree of them: a choice map of
collected samples); each diagnostic is a dense reduction over the chain
and step axes plus, for the ESS, one FFT for the autocovariance. Nothing
reads the device on the host.
"""

import math

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.typing import as_float

__all__ = ["split_rhat", "effective_sample_size"]


def _split_chains(x: torch.Tensor) -> torch.Tensor:
    """(m, n, ...) -> (2m, n//2, ...); odd steps drop the last draw."""
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], x[:, half : 2 * half]], dim=0)


def _rhat_array(x) -> torch.Tensor:
    x = as_float(x)
    if x.dim() < 2:
        raise ValueError(
            f"split_rhat expects samples of shape (n_chains, n_steps, ...); got shape {tuple(x.shape)}."
        )
    x = _split_chains(x)
    n = x.shape[1]
    chain_means = x.mean(dim=1)
    chain_vars = x.var(dim=1, correction=1)
    between = n * chain_means.var(dim=0, correction=1)
    within = chain_vars.mean(dim=0)
    var_plus = (n - 1) / n * within + between / n
    return torch.sqrt(var_plus / within)


def split_rhat(samples):
    """Split-chain potential scale reduction factor, per leaf of
    `samples` (leading axes `(n_chains, n_steps, ...)`). Values near 1
    mean the chains agree.

    >>> import torch
    >>> from genjax_tpu_torch.inference.diagnostics import split_rhat
    >>> good = torch.randn(8, 500, generator=torch.Generator().manual_seed(0))
    >>> bool(split_rhat(good) < 1.02)
    True
    >>> stuck = good + 10.0 * torch.arange(8.0)[:, None]  # disjoint chains
    >>> bool(split_rhat(stuck) > 2.0)
    True
    """
    return pytree.tree_map(_rhat_array, samples)


def _ess_array(x) -> torch.Tensor:
    x = as_float(x)
    if x.dim() < 2:
        raise ValueError(
            f"effective_sample_size expects samples of shape (n_chains, n_steps, ...); got shape {tuple(x.shape)}."
        )
    m, n = x.shape[0], x.shape[1]
    # Per-chain autocovariance by FFT, zero-padded to twice the length so
    # that nothing wraps around.
    centered = x - x.mean(dim=1, keepdim=True)
    size = 2 * n
    f = torch.fft.rfft(centered, n=size, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=1)[:, :n] / n
    mean_acov = acov.mean(dim=0)
    chain_var = x.var(dim=1, correction=1).mean(dim=0)
    between = x.mean(dim=1).var(dim=0, correction=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * chain_var + between
    # The combined autocorrelation (Vehtari et al. eq. 10).
    rho = 1.0 - (chain_var - mean_acov) / var_plus

    # Geyer: sum consecutive lag pairs, stop at the first pair that is not
    # positive, and make the sums monotone: a cummin and a masked sum.
    n_pairs = n // 2
    pair_sums = rho[0 : 2 * n_pairs : 2] + rho[1 : 2 * n_pairs : 2]
    first_nonpositive = torch.cumprod((pair_sums > 0.0).to(torch.int32), dim=0)
    monotone = torch.cummin(pair_sums, dim=0).values
    tau = -1.0 + 2.0 * (monotone * first_nonpositive).sum(dim=0)
    # A floor on tau: antithetic chains may exceed the draw count only
    # boundedly (the arviz/Stan convention).
    tau_floor = 1.0 / math.log10(float(m * n)) if m * n > 10 else 1.0
    tau = torch.clamp(tau, min=tau_floor)
    return m * n / tau


def effective_sample_size(samples):
    """Multi-chain effective sample size, per leaf of `samples` (leading
    axes `(n_chains, n_steps, ...)`). Independent draws give about the
    total draw count; autocorrelation shrinks it.

    >>> import torch
    >>> from genjax_tpu_torch.inference.diagnostics import effective_sample_size
    >>> iid = torch.randn(8, 500, generator=torch.Generator().manual_seed(1))
    >>> 2500 < float(effective_sample_size(iid))  # 4000 draws
    True
    """
    return pytree.tree_map(_ess_array, samples)
