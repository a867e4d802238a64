"""Structural time series: level, trend, seasonal and AR state-space
components with exact Kalman inference and marginal-likelihood fitting.

Counterpart of `genjax_tpu/models/sts.py`: `local_level`,
`local_linear_trend`, `seasonal`, `ar` and `StructuralTimeSeries` (`ssm`,
`lml`, `decompose`, `forecast`, `fit`). Components assemble
block-diagonally into a `LinearGaussianSSM`, so filtering, smoothing,
decomposition, forecasting and the exact log marginal likelihood come
from `inference/kalman.py`; the filter is differentiable, so `fit` trains
the noise scales by Adam ascent on the exact evidence (Adam written out
with optax's defaults, `inference/map_laplace.py::adam`). Each component
is made on the CUDA card unless the caller passes `device="cpu"`.
"""

from typing import Any

import torch

from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray
from genjax_tpu_torch.inference.kalman import LinearGaussianSSM

__all__ = ["ar", "local_level", "local_linear_trend", "seasonal", "StructuralTimeSeries"]


def _f(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.get_default_dtype(), device=device)


@Pytree.dataclass
class _Component(Pytree):
    """One block: transition `A` (d, d), process noise standard deviations
    `q` (d,), emission row `h` (d,), initial standard deviations `p0`
    (d,)."""

    name: str = Pytree.static()
    A: FloatArray
    q: FloatArray
    h: FloatArray
    p0: FloatArray


def local_level(level_scale=0.1, initial_scale=10.0, device="cuda") -> _Component:
    """Random-walk level: x_t = x_{t-1} + N(0, level_scale^2)."""
    return _Component(
        "level", torch.eye(1, device=device), _f([level_scale], device), torch.ones(1, device=device),
        _f([initial_scale], device),
    )


def local_linear_trend(level_scale=0.1, slope_scale=0.05, initial_scale=10.0, device="cuda") -> _Component:
    """Level plus integrated slope (Holt's trend)."""
    return _Component(
        "trend",
        _f([[1.0, 1.0], [0.0, 1.0]], device),
        _f([level_scale, slope_scale], device),
        _f([1.0, 0.0], device),
        torch.full((2,), float(initial_scale), device=device),
    )


def seasonal(num_seasons: int, drift_scale=0.01, initial_scale=5.0, device="cuda") -> _Component:
    """Sum-to-zero seasonal effect with `num_seasons` seasons: the current
    effect is minus the sum of the previous S-1 plus drift noise."""
    s = num_seasons - 1
    A = torch.diag(torch.ones(s - 1, device=device), -1)
    A[0] = -1.0
    q = torch.zeros(s, device=device)
    q[0] = float(drift_scale)
    h = torch.zeros(s, device=device)
    h[0] = 1.0
    return _Component(f"seasonal{num_seasons}", A, q, h, torch.full((s,), float(initial_scale), device=device))


def ar(coefficient=0.8, scale=0.2, initial_scale=None, device="cuda") -> _Component:
    """AR(1) disturbance component."""
    if initial_scale is None:
        initial_scale = float(scale) / max((1.0 - float(coefficient) ** 2) ** 0.5, 1e-3)  # stationary std
    return _Component(
        "ar1", _f([[coefficient]], device), _f([scale], device), torch.ones(1, device=device),
        _f([initial_scale], device),
    )


@Pytree.dataclass
class StructuralTimeSeries(Pytree):
    """A sum of STS components observed with Gaussian noise; the series is
    on the components' device.

    >>> import torch
    >>> from genjax_tpu_torch.models.sts import StructuralTimeSeries, local_level, seasonal
    >>> sts = StructuralTimeSeries((local_level(0.2, device="cpu"), seasonal(4, 0.01, device="cpu")), obs_noise=0.3)
    >>> _, ys = sts.ssm().sample(torch.Generator().manual_seed(0), 40)
    >>> float(sts.lml(ys[:, 0])) < 0.0
    True
    >>> sorted(sts.decompose(ys[:, 0]))
    ['level', 'seasonal4']
    """

    components: tuple
    obs_noise: Any = 0.1

    def _dims(self):
        return [c.A.shape[0] for c in self.components]

    def ssm(self) -> LinearGaussianSSM:
        """The block-diagonal LinearGaussianSSM."""
        dims = self._dims()
        d = sum(dims)
        ref = self.components[0].A
        A = ref.new_zeros(d, d)
        Q = ref.new_zeros(d, d)
        P0 = ref.new_zeros(d, d)
        H = ref.new_zeros(1, d)
        off = 0
        for c, dc in zip(self.components, dims):
            sl = slice(off, off + dc)
            A[sl, sl] = c.A
            Q[sl, sl] = torch.diag(c.q**2)
            P0[sl, sl] = torch.diag(c.p0**2)
            H[0, sl] = c.h
            off += dc
        R = torch.as_tensor(self.obs_noise, dtype=ref.dtype, device=ref.device) ** 2
        return LinearGaussianSSM(A, Q, H, R.reshape(1, 1), ref.new_zeros(d), P0)

    def lml(self, ys: FloatArray) -> FloatArray:
        """Exact log marginal likelihood of the (T,) series."""
        return self.ssm().lml(ys[:, None])

    def decompose(self, ys: FloatArray) -> dict:
        """Smoothed per-component contributions `{name: (T,) series}`."""
        mus, _ = self.ssm().smooth(ys[:, None])
        out = {}
        off = 0
        for c, dc in zip(self.components, self._dims()):
            out[c.name] = mus[:, off : off + dc] @ c.h
            off += dc
        return out

    def forecast(self, ys: FloatArray, horizon: int):
        """Predictive means and VARIANCES for the next `horizon` steps given
        the (T,) history, in closed form."""
        m = self.ssm()
        mus, Ps, _ = m.filter(ys[:, None])
        mu, P = mus[-1], Ps[-1]
        means, variances = [], []
        for _ in range(horizon):
            mu = m.A @ mu
            P = m.A @ P @ m.A.mT + m.Q
            means.append((m.H @ mu)[0])
            variances.append((m.H @ P @ m.H.mT + m.R)[0, 0])
        return torch.stack(means), torch.stack(variances)

    def fit(self, ys: FloatArray, n_steps: int = 300, learning_rate: float = 0.05):
        """Maximize the exact marginal likelihood over every component's
        noise scales and the observation noise, by Adam in log-scale space
        (autograd through the filter). Process-noise entries that are zero
        by construction (the seasonal block's non-drift states) stay zero.
        Returns `(fitted_sts, lml_history)`."""
        from genjax_tpu_torch.inference.map_laplace import adam

        masks = [c.q > 0 for c in self.components]
        params = [torch.log(c.q + 1e-8) for c in self.components]
        params.append(torch.log(torch.as_tensor(self.obs_noise, dtype=ys.dtype, device=ys.device) + 1e-8))

        def unpack(params):
            comps = tuple(
                _Component(c.name, c.A, torch.where(mask, torch.exp(lq), 0.0), c.h, c.p0)
                for c, lq, mask in zip(self.components, params[:-1], masks)
            )
            return StructuralTimeSeries(comps, torch.exp(params[-1]))

        optimizer = adam(learning_rate)
        state = optimizer.init(params)
        history = []
        for _ in range(n_steps):
            leaves = [p.detach().requires_grad_() for p in params]
            with torch.enable_grad():
                neg_lml = -unpack(leaves).lml(ys)
                grads = torch.autograd.grad(neg_lml, leaves)
            updates, state = optimizer.update(list(grads), state)
            params = [p.detach() + u for p, u in zip(params, updates)]
            history.append(-neg_lml.detach())
        return unpack(params), torch.stack(history)
