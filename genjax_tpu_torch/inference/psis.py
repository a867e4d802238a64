"""Pareto-smoothed importance sampling (PSIS), PSIS-LOO and WAIC.

Counterpart of `genjax_tpu/inference/psis.py`: `fit_gpd_shape`,
`pareto_k`, `psis_smooth`, `elpd_loo`, `elpd_waic`, `LOOResult` and
`WAICResult` (Vehtari, Simpson, Gelman, Yao & Gabry 2024; Vehtari, Gelman
& Gabry 2017). A generalized Pareto fit to the largest weights gives the
shape k-hat (k < 0.7: the estimate is reliable) and replaces the tail
weights by the fitted quantiles. The fit is Zhang & Stephens' (2009)
profile posterior on a fixed grid: a (grid x tail) broadcast, no Newton
iterations. Every function acts on the last axis and batches over the
others, so `elpd_loo` smooths every data point's column at once.
"""

import math

import torch

from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray, as_float

__all__ = ["LOOResult", "WAICResult", "elpd_loo", "elpd_waic", "fit_gpd_shape", "pareto_k", "psis_smooth"]

_GRID = 128


def fit_gpd_shape(tail: FloatArray) -> tuple[FloatArray, FloatArray]:
    """Fit a generalized Pareto to `tail` (exceedances over a threshold,
    positive, along the last axis). Returns `(k, sigma)`.

    Zhang & Stephens (2009): the profile likelihood over theta (= -xi /
    sigma), with k(theta) = mean(log1p(-theta * x)), on a fixed grid of
    theta, averaged under the normalized profile weights; then the
    small-sample shrinkage toward 0.5 (Vehtari et al. 2024, app. C).
    """
    x = as_float(tail)
    n = x.shape[-1]
    x_max = x.max(-1).values
    m = _GRID
    x_star = torch.quantile(x, 0.25, dim=-1)
    j = torch.arange(1, m + 1, dtype=x.dtype, device=x.device)
    theta = 1.0 / x_max[..., None] + (1.0 - torch.sqrt(m / (j - 0.5))) / (3.0 * x_star[..., None])
    # k(theta) = mean log(1 - theta x): theta and k have opposite signs, so
    # sigma = -k / theta > 0; k == 0 (an all-equal tail) is guarded.
    k = torch.log1p(-theta[..., :, None] * x[..., None, :]).mean(-1)
    k = torch.where(k == 0.0, -torch.sign(theta) * 1e-30, k)
    lls = n * (torch.log(-theta / k) - k - 1.0)
    w = torch.softmax(lls, dim=-1)
    theta_hat = (w * theta).sum(-1)
    k_hat = torch.log1p(-theta_hat[..., None] * x).mean(-1)
    sigma_hat = -k_hat / theta_hat
    k_hat = (n * k_hat + 5.0) / (n + 10.0)
    return k_hat, sigma_hat


def _tail_size(n: int) -> int:
    return int(min(0.2 * n, 3.0 * math.sqrt(n)))


def pareto_k(log_weights: FloatArray) -> FloatArray:
    """The PSIS k-hat of an importance-weight vector (of each row of a
    batch): k < 0.5 excellent, k < 0.7 usable, k >= 0.7 unreliable. Fewer
    than 25 weights give +inf ("cannot certify").

    >>> import torch
    >>> from genjax_tpu_torch.inference.psis import pareto_k
    >>> lw = torch.randn(4000, generator=torch.Generator().manual_seed(0))  # lognormal w
    >>> float(pareto_k(lw)) < 0.5
    True
    """
    return psis_smooth(log_weights)[1]


def psis_smooth(log_weights: FloatArray) -> tuple[FloatArray, FloatArray]:
    """Pareto-smooth log weights along the last axis; returns
    `(smoothed_log_weights, k_hat)`. The M = min(n/5, 3 sqrt(n)) largest
    weights become the expected order statistics of the fitted GPD, capped
    at the raw maximum; the others pass through, and the total is not
    renormalized. With fewer than 25 entries the weights come back as they
    are with k = +inf.

    >>> import torch
    >>> from genjax_tpu_torch.inference.psis import psis_smooth
    >>> lw = 2.0 * torch.randn(4000, generator=torch.Generator().manual_seed(1))
    >>> sm, k = psis_smooth(lw)
    >>> bool(sm.max() <= lw.max() + 1e-5), sm.shape
    (True, torch.Size([4000]))
    """
    lw = as_float(log_weights)
    n = lw.shape[-1]
    m = _tail_size(n)
    if m < 5:
        return lw, torch.full(lw.shape[:-1], torch.inf, dtype=lw.dtype, device=lw.device)

    lw_max = lw.max(-1, keepdim=True).values
    top_vals, top_idx = torch.topk(lw - lw_max, m + 1, dim=-1)
    # The threshold is the (m+1)-th largest; the tail is the top m.
    cutoff = top_vals[..., m : m + 1]
    tail_lw = top_vals[..., :m]
    exceed = torch.exp(tail_lw) - torch.exp(cutoff)
    # A degenerate tail (every weight about equal: the proposal is the
    # target) has nothing to fit: k = -inf, weights untouched.
    degenerate = exceed.max(-1).values <= 1e-10
    k_fit, sigma = fit_gpd_shape(torch.where(degenerate[..., None], exceed + 1.0, exceed))

    # GPD quantiles at p_j = (j - 1/2) / m, the largest to the largest
    # weight (topk sorts descending, the quantiles ascend: flip).
    p = (torch.arange(1, m + 1, dtype=lw.dtype, device=lw.device) - 0.5) / m
    k_b, s_b = k_fit[..., None], sigma[..., None]
    q = torch.exp(cutoff) + (s_b / k_b) * (torch.pow(1.0 - p, -k_b) - 1.0)
    q = torch.minimum(q, torch.exp(top_vals[..., :1]))  # never above the raw max
    smoothed_tail = torch.where(degenerate[..., None], tail_lw, torch.log(q).flip(-1))
    # Scatter into the original vector, so untouched entries round-trip
    # exactly (lw - max + max may not).
    out = lw.scatter(-1, top_idx[..., :m], smoothed_tail + lw_max)
    return out, torch.where(degenerate, -torch.inf, k_fit)


@Pytree.dataclass
class LOOResult(Pytree):
    """PSIS-LOO: `elpd` (the expected log pointwise predictive density for
    held-out data), `se`, `p_loo` (in-sample lpd less elpd), the
    per-point `pointwise` contributions and `pareto_k` diagnostics."""

    elpd: FloatArray
    se: FloatArray
    p_loo: FloatArray
    pointwise: FloatArray
    pareto_k: FloatArray


def _check_matrix(ll, name: str) -> torch.Tensor:
    ll = as_float(ll)
    if ll.dim() != 2:
        raise ValueError(f"{name} expects loglik of shape (n_draws, n_data); got {tuple(ll.shape)}.")
    return ll


def _se(pointwise: torch.Tensor) -> torch.Tensor:
    n = pointwise.shape[0]
    if n > 1:
        return torch.sqrt(n * pointwise.var(correction=1))
    return torch.full((), torch.inf, dtype=pointwise.dtype, device=pointwise.device)


def elpd_loo(loglik: FloatArray) -> LOOResult:
    """Pareto-smoothed importance-sampling leave-one-out cross-validation
    from the `(n_draws, n_data)` pointwise log-likelihood matrix
    `loglik[s, i] = log p(y_i | theta_s)`. Each point's weights
    `1 / p(y_i | theta_s)` are smoothed, all points at once.

    >>> import math, torch
    >>> from genjax_tpu_torch.inference.psis import elpd_loo
    >>> g = torch.Generator().manual_seed(0)
    >>> y, mus = torch.randn(40, generator=g), 0.1 * torch.randn(2000, 1, generator=g)
    >>> ll = -0.5 * (y - mus) ** 2 - 0.5 * math.log(2 * math.pi)
    >>> res = elpd_loo(ll)
    >>> res.pointwise.shape, res.pareto_k.shape
    (torch.Size([40]), torch.Size([40]))
    >>> bool(res.elpd < torch.logsumexp(ll, 0).sum() - 40 * math.log(2000.0))  # LOO pays
    True
    """
    ll = _check_matrix(loglik, "elpd_loo")
    s = ll.shape[0]
    cols = ll.mT
    sm, ks = psis_smooth(-cols)
    pointwise = torch.logsumexp(sm + cols, -1) - torch.logsumexp(sm, -1)
    lpd = torch.logsumexp(ll, 0) - math.log(float(s))
    return LOOResult(
        elpd=pointwise.sum(), se=_se(pointwise), p_loo=(lpd - pointwise).sum(), pointwise=pointwise, pareto_k=ks
    )


@Pytree.dataclass
class WAICResult(Pytree):
    """WAIC: `elpd`, `se`, `p_waic` (the summed pointwise posterior
    variances of the log-likelihood) and the `pointwise` contributions."""

    elpd: FloatArray
    se: FloatArray
    p_waic: FloatArray
    pointwise: FloatArray


def elpd_waic(loglik: FloatArray) -> WAICResult:
    """The widely applicable information criterion (Watanabe 2010) in the
    elpd convention of Vehtari, Gelman & Gabry 2017:
    `elpd_waic_i = lpd_i - var_s(loglik[s, i])`.

    >>> import torch
    >>> from genjax_tpu_torch.inference.psis import elpd_waic
    >>> ll = -0.5 * torch.randn(2000, 25, generator=torch.Generator().manual_seed(0)) ** 2
    >>> res = elpd_waic(ll)
    >>> res.pointwise.shape, bool(res.p_waic > 0.0)
    (torch.Size([25]), True)
    """
    ll = _check_matrix(loglik, "elpd_waic")
    s = ll.shape[0]
    lpd = torch.logsumexp(ll, 0) - math.log(float(s))
    p_i = ll.var(0, correction=1)
    pointwise = lpd - p_i
    return WAICResult(elpd=pointwise.sum(), se=_se(pointwise), p_waic=p_i.sum(), pointwise=pointwise)
