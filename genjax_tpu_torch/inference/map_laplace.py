"""MAP estimation and Laplace approximation over selected choices.

Counterpart of `genjax_tpu/inference/map_laplace.py`: `map_estimate`
(gradient ascent on the model's log joint over a `Selection`, everything
else held fixed), `laplace_approximation` (a Gaussian from the curvature
at the mode, with the Laplace evidence estimate

    log p(y) ~ log p(map, y) + d/2 log 2pi - 1/2 log det(-H))

and `LaplaceApproximation`. JAX's default optimizer is `optax.adam(0.05)`;
here `adam` writes out the same update with optax's defaults (bias-corrected
moments, eps 1e-8 outside the square root), so the iterates agree step for
step. The Hessian is `torch.func.hessian` of the flattened selected
vector (dense d x d: for modest parameter blocks).
"""

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import Selection
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import batched_mask
from genjax_tpu_torch.core.gfi import Trace, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray, plain
from genjax_tpu_torch.inference.requests.hmc import _is_float, make_selection_grad_fn

__all__ = ["LaplaceApproximation", "adagrad", "adam", "laplace_approximation", "map_estimate"]


class adam:
    """Adam with optax's formula and defaults, as a gradient
    transformation over a list of tensors: `init(params)` gives the state,
    `update(grads, state)` the updates to add (descent on `grads`) and the
    new state."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params: list) -> tuple:
        zeros = [torch.zeros_like(p) for p in params]
        return (0, zeros, list(zeros))

    def update(self, grads: list, state: tuple) -> tuple[list, tuple]:
        count, mu, nu = state
        count += 1
        mu = [self.b1 * m + (1 - self.b1) * g for m, g in zip(mu, grads)]
        nu = [self.b2 * v + (1 - self.b2) * g * g for v, g in zip(nu, grads)]
        c1, c2 = 1 - self.b1**count, 1 - self.b2**count
        updates = [-self.learning_rate * (m / c1) / (torch.sqrt(v / c2) + self.eps) for m, v in zip(mu, nu)]
        return updates, (count, mu, nu)


class adagrad:
    """Adagrad with optax's formula and defaults (`optax.adagrad`: the
    accumulator starts at `initial_accumulator_value`, and the update is
    `-lr * g / sqrt(sum g^2 + eps)` where the sum is positive), with
    `adam`'s `init`/`update` over a list of tensors."""

    def __init__(self, learning_rate: float, initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        self.learning_rate, self.initial_accumulator_value, self.eps = learning_rate, initial_accumulator_value, eps

    def init(self, params: list) -> list:
        return [torch.full_like(p, self.initial_accumulator_value) for p in params]

    def update(self, grads: list, state: list) -> tuple[list, list]:
        state = [g * g + s for g, s in zip(grads, state)]
        updates = [
            -self.learning_rate * torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0) * g for g, s in zip(grads, state)
        ]
        return updates, state


def map_estimate(
    rng: torch.Generator,
    trace: Trace[Any],
    selection: Selection,
    n_steps: int = 500,
    optimizer: Any = None,
) -> tuple[Trace[Any], FloatArray]:
    """Maximize the model's log joint over the selected choices (of each
    chain, for a trace with a chain axis). Returns `(map_trace,
    log_density_history)`: the input trace updated with the optimized
    values (one `Update`), and the log density before each step. The
    optimizer is `adam(0.05)` unless given (anything with `adam`'s
    `init`/`update`).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.map_laplace import map_estimate
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(obs=1.0), ())
    >>> map_tr, hist = map_estimate(rng, tr, gx.Selection.at["mu"])
    >>> bool(abs(map_tr.get_choices()["mu"] - 0.5) < 1e-3)  # the exact mode
    True
    """
    if optimizer is None:
        optimizer = adam(0.05)
    argdiffs = Diff.no_change(trace.get_args())
    grad_fn = make_selection_grad_fn(selection, trace, argdiffs)
    values = trace.get_choices().filter(selection)
    leaves, spec = pytree.tree_flatten(values)
    idx = [i for i, v in enumerate(leaves) if _is_float(v)]
    state = optimizer.init([leaves[i] for i in idx])
    hist = []
    for _ in range(n_steps):
        score, grads = grad_fn(pytree.tree_unflatten(leaves, spec))
        g = pytree.tree_leaves(grads)
        # Ascent: the optimizer descends, so it gets the negated gradient.
        updates, state = optimizer.update([-g[i] for i in idx], state)
        leaves = list(leaves)
        for i, u in zip(idx, updates):
            leaves[i] = plain(leaves[i]) + u
        hist.append(score)
    map_trace, _, _, _ = Update(pytree.tree_unflatten(leaves, spec)).edit(rng, trace, argdiffs)
    return map_trace, torch.stack(hist)


@Pytree.dataclass
class LaplaceApproximation(Pytree):
    """A Gaussian at a mode: the flat `mean` (`unravel` maps a flat vector
    back to the selected choices), the dense `covariance`, and the Laplace
    evidence estimate `log_marginal`."""

    mean: FloatArray
    covariance: FloatArray
    log_marginal: FloatArray
    unravel: Any = Pytree.static()

    def sample(self, rng: torch.Generator, n: int | None = None):
        """Draws from the approximation, as selected-choice maps (with a
        leading axis of `n`)."""
        chol = torch.linalg.cholesky(self.covariance)
        shape = (self.mean.shape[0],) if n is None else (n, self.mean.shape[0])
        eps = torch.randn(shape, generator=rng, device=self.mean.device, dtype=self.mean.dtype)
        return self.unravel(self.mean + eps @ chol.mT)


def laplace_approximation(trace: Trace[Any], selection: Selection) -> LaplaceApproximation:
    """The Laplace approximation around `trace`'s selected values (one
    trace, no chain axis; run `map_estimate` first so that they sit at the
    mode). The negative Hessian of the log joint in the flattened selected
    vector is the precision; `log_marginal` is exact when the joint is
    Gaussian in the selected values.

    >>> import math, torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.map_laplace import laplace_approximation, map_estimate
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(obs=1.0), ())
    >>> map_tr, _ = map_estimate(rng, tr, gx.Selection.at["mu"])
    >>> lap = laplace_approximation(map_tr, gx.Selection.at["mu"])
    >>> exact = float(gx.normal.logpdf(torch.tensor(1.0), 0.0, math.sqrt(2.0)))
    >>> abs(float(lap.log_marginal) - exact) < 1e-3, abs(float(lap.covariance[0, 0]) - 0.5) < 1e-3
    (True, True)
    """
    if trace.particle_count() is not None:
        raise ValueError("laplace_approximation takes one trace (no chain axis)")
    gen_fn = trace.get_gen_fn()
    args = trace.get_args()
    chm = trace.get_choices()
    values = chm.filter(selection)
    complement = chm.filter(~selection)
    leaves, spec, _ = batched_mask(values)
    idx = [i for i, v in enumerate(leaves) if _is_float(v)]
    shapes = [leaves[i].shape for i in idx]
    sizes = [s.numel() for s in shapes]
    flat = torch.cat([plain(leaves[i]).reshape(-1) for i in idx])

    def unravel(x: torch.Tensor):
        out = list(leaves)
        batch = x.shape[:-1]
        for i, s, part in zip(idx, shapes, torch.split(x, sizes, dim=-1)):
            out[i] = part.reshape(batch + s)
        return pytree.tree_unflatten(out, spec)

    def flat_logp(x: torch.Tensor) -> torch.Tensor:
        score, _ = gen_fn.assess(unravel(x) | complement, args)
        return score

    d = flat.shape[0]
    hess = torch.func.hessian(flat_logp)(flat)
    precision = -hess
    covariance = torch.linalg.inv(precision)
    _, logdet = torch.linalg.slogdet(precision)
    log_marginal = flat_logp(flat) + 0.5 * d * math.log(2.0 * math.pi) - 0.5 * logdet
    return LaplaceApproximation(mean=flat, covariance=covariance, log_marginal=log_marginal, unravel=unravel)
