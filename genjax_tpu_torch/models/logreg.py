"""Bayesian logistic regression: HMC, MALA and NUTS over thousands of
chains.

Counterpart of `genjax_tpu/models/logreg.py`. JAX writes one chain's
`X @ w` and lets `vmap` batch it; here the body runs once on the chain
batch, so it writes `w @ X.mT`, which is right for one chain's `(D,)` and
for C chains' `(C, D)`: one shared-operand `(C, D) @ (D, N)` matmul per
density pass.
"""

import dataclasses

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.distributions.library import bernoulli, mv_normal_diag
from genjax_tpu_torch.inference.mcmc import run_chains, share_chain_args
from genjax_tpu_torch.inference.requests import HMC, MALA, NUTS
from genjax_tpu_torch.lang.static import gen


@gen
def logistic_regression(X):
    d = X.shape[-1]
    w = mv_normal_diag(X.new_zeros(d), X.new_ones(d)) @ "w"
    logits = w @ X.mT
    # The logits form scores with softplus, stable where the sigmoid
    # saturates in float32 (and would give NaN HMC gradients).
    _ = bernoulli(logits=logits) @ "ys"
    return logits


@gen
def datum(x, w):
    """One data point's likelihood, as a kernel for `vmap`: `x` is one row
    of the design matrix (under the lane axis `(N, D)`), `w` the weights
    (`(D,)`, or `(C, 1, D)` for C chains). Returns the logit."""
    logit = (x * w).sum(-1)
    _ = bernoulli(logits=logit) @ "y"
    return logit


@gen
def logistic_regression_vmap(X):
    """The same model with the likelihood as a generative function per
    data point: `ys` lives at `("data", i, "y")`, stacked at
    `VMAP_YS`."""
    d = X.shape[-1]
    w = mv_normal_diag(X.new_zeros(d), X.new_ones(d)) @ "w"
    return datum.vmap(in_axes=(0, None))(X, w) @ "data"


VMAP_YS = ("data", "y")  # where `logistic_regression_vmap` holds the observations


def simulate_logreg_data(rng: torch.Generator, n: int, d: int):
    """(X, ys, w_true) on the generator's device: `X` is (n, d) standard
    normal, `ys` int32 Bernoulli(sigmoid(X @ w_true))."""
    X = torch.randn(n, d, generator=rng, device=rng.device)
    w_true = torch.randn(d, generator=rng, device=rng.device)
    u = torch.rand(n, generator=rng, device=rng.device)
    ys = (u < torch.sigmoid(X @ w_true)).to(torch.int32)
    return X, ys, w_true


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """HMC as `bench.py:605-644` runs it (BASELINE config 4), and MALA and
    NUTS at the same width (NUTS as `bench.py:714-750` runs it, at
    `nuts_max_depth` and once at `nuts_deep_max_depth`): the configuration
    of `chip_smoke.py` and `profiling.py`."""

    n_chains: int = 8192
    n_data: int = 256
    dim: int = 16
    eps: float = 0.02
    L: int = 5
    n_steps: int = 10
    mala_eps: float = 0.01
    nuts_max_depth: int = 6
    nuts_deep_max_depth: int = 8
    data_seed: int = 3

    def data(self, device: torch.device | str):
        """(X, ys) drawn on the CPU from `data_seed`, then moved to
        `device`, so that every device sees the same data."""
        X, ys, _ = simulate_logreg_data(torch.Generator().manual_seed(self.data_seed), self.n_data, self.dim)
        return X.to(device), ys.to(device)


def init_chains(rng: torch.Generator, X, ys, n_chains: int, model=logistic_regression, ys_address="ys"):
    """`n_chains` chains drawn from the prior, `ys` observed: one trace
    with the chain axis on `w` and one shared copy of `X` and `ys`.
    `model` takes `(X,)`, draws `"w"` and holds the observations at
    `ys_address`: `"ys"` for `logistic_regression`, `VMAP_YS` for
    `logistic_regression_vmap`."""
    trs, _ = model.importance(rng, ChoiceMap.d({ys_address: ys}), (X,), n=n_chains)
    return share_chain_args(trs, (X,))


def run_hmc_chains(
    rng: torch.Generator, X, ys, n_chains: int = 8192, n_steps: int = 100, eps: float = 0.05, L: int = 10,
    model=logistic_regression, ys_address="ys",
):
    """HMC over `n_chains` chains: returns (final `w`, `(C, n_steps)`
    accept flags). `model` and `ys_address` as `init_chains` takes them."""
    trs = init_chains(rng, X, ys, n_chains, model, ys_address)
    finals, accs = run_chains(rng, trs, HMC(Selection.at["w"], eps, L=L), n_steps)
    return finals.get_choices()["w"], accs


def run_mala_chains(rng: torch.Generator, X, ys, n_chains: int = 8192, n_steps: int = 100, eps: float = 0.01):
    """MALA over `n_chains` chains: returns (final `w`, accept flags)."""
    trs = init_chains(rng, X, ys, n_chains)
    finals, accs = run_chains(rng, trs, MALA(Selection.at["w"], eps), n_steps)
    return finals.get_choices()["w"], accs


def run_nuts_chains(
    rng: torch.Generator, X, ys, n_chains: int = 8192, n_steps: int = 100, eps: float = 0.05, max_depth: int = 6
):
    """NUTS over `n_chains` chains: returns (final `w`, `(C, n_steps)`
    accept flags, all true: NUTS's weight is 0). Each draw costs
    `2**max_depth - 1` gradient passes over the batch (the fixed schedule
    of `inference/requests/nuts.py`), and no step reads the device."""
    trs = init_chains(rng, X, ys, n_chains)
    finals, accs = run_chains(rng, trs, NUTS(Selection.at["w"], eps, max_depth=max_depth), n_steps)
    return finals.get_choices()["w"], accs
