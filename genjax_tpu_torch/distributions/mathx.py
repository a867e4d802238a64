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


def softplus(x):
    """`log(1 + e^x)` of a Python number or a tensor."""
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.softplus(x)
    return max(x, 0.0) + math.log1p(math.exp(-abs(x)))


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


def _tensor(x, like=None):
    """`x` as a float32 tensor on the device of `like` (or of `x`); a
    Python number is filled there."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(DEFAULT_DTYPE)
    return torch.full((), float(x), dtype=DEFAULT_DTYPE, device=device_of(like))


def log_binom(n, k):
    """`log C(n, k)` via `lgamma` (real `n`, `k`)."""
    return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)


def log_bessel_i0(x):
    """`log I0(x)`, stable for large `x` (`I0(x) = i0e(x) e^|x|`)."""
    x = _tensor(x)
    return torch.log(torch.special.i0e(x)) + x.abs()


def log_bessel_i1(x):
    x = _tensor(x)
    return torch.log(torch.special.i1e(x)) + x.abs()


_LOG_2 = math.log(2.0)


def log_bessel_ive(v, z, num_terms: int = 40):
    """`log Ive(v, z) = log Iv(z) - |z|` for real order `v >= 0`, `z >= 0`:
    the power series `sum_m (z/2)^(2m+v) / (m! Gamma(m+v+1))` over
    `num_terms` terms in log space, or for `z > v^2/2 + 20` the leading
    uniform asymptotic (Olver) term with its first correction; the same
    terms and switch as `genjax_tpu/distributions/mathx.py`. In float32 the
    series loses accuracy as `z` nears the switch (about 1e-5 relative)."""
    z = _tensor(z, v)
    v = _tensor(v, z)
    m = torch.arange(num_terms, dtype=z.dtype, device=z.device)
    log_z = torch.log(torch.clamp(z, min=1e-30))
    terms = (
        (2.0 * m + v[..., None]) * (log_z[..., None] - _LOG_2)
        - torch.lgamma(m + 1.0)
        - torch.lgamma(m + v[..., None] + 1.0)
    )
    log_ive_series = torch.logsumexp(terms, dim=-1) - z
    p = torch.sqrt(v * v + z * z)
    eta = p + v * torch.log(torch.clamp(z, min=1e-30) / torch.clamp(v + p, min=1e-30))
    t = v / torch.clamp(p, min=1e-30)
    u1 = (3.0 * t - 5.0 * t**3) / 24.0
    correction = torch.log1p(u1 / torch.clamp(p, min=1e-30))
    log_ive_asym = eta - z - 0.5 * math.log(2.0 * math.pi) - 0.25 * torch.log(v * v + z * z) + correction
    return torch.where(z > v * v / 2.0 + 20.0, log_ive_asym, log_ive_series)


def log_bessel_iv(v, z, num_terms: int = 40):
    """`log Iv(z)` for `v >= 0`, `z >= 0`."""
    z = _tensor(z, v)
    return log_bessel_ive(v, z, num_terms) + z.abs()


def lambertw(z, iters: int = 20):
    """The principal branch of Lambert's W (`W(z) e^W(z) = z`) for
    `z >= 0`, by `iters` Halley steps from JAX's starting point."""
    z = _tensor(z)
    safe = torch.clamp(z, min=1e-30)
    w = torch.where(z > math.e, torch.log(safe) - torch.log(torch.clamp(torch.log(safe), min=1e-30)), z / (1.0 + z))
    for _ in range(iters):
        ew = torch.exp(w)
        f = w * ew - z
        wp1 = w + 1.0
        w = w - f / (ew * wp1 - (w + 2.0) * f / (2.0 * wp1))
    return w


def erfcinv(x):
    """The inverse of `erfc`: `erfinv(1 - x)`."""
    return torch.special.erfinv(1.0 - _tensor(x))


def stirling_poisson_logpmf(k, rate):
    """The Poisson log mass `k log(rate) - rate - log k!`."""
    return xlogy(k, rate) - rate - gammaln(k + 1.0)


def gamma_fn(x):
    """`Gamma(x)` with its sign (`exp(lgamma)` is `|Gamma|`): negative on
    `(-1, 0)`, `(-3, -2)`, ..."""
    negative = (x < 0) & (torch.remainder(torch.floor(x), 2.0) == 1.0)
    return torch.where(negative, -1.0, 1.0) * torch.exp(torch.lgamma(x))


_HYP2F1_TERMS = 250
_CHECK_EVERY = 25  # trips between the host's reads of "every lane converged"


def _converging(step, state, done):
    """Run `step(state, k) -> (state, done)` for k = 1, 2, ... up to
    `_HYP2F1_TERMS` trips, stopping early once every lane is done (read on
    the host once every `_CHECK_EVERY` trips)."""
    for k in range(1, _HYP2F1_TERMS + 1):
        state, done = step(state, k, done)
        if k % _CHECK_EVERY == 0 and bool(done.all()):
            break
    return state


def _hyp2f1_serie(a, b, c, x):
    # Taylor series (Pearson, Olver & Porter 2014, eq. 4.1) until a term is
    # below float32 epsilon of the sum, at most 250 terms, lane by lane.
    rtol = torch.finfo(x.dtype).eps

    def step(state, k, done):
        serie, term = state
        serie = torch.where(done, serie, serie + term)
        term = torch.where(done, term, term * (a + k - 1) * (b + k - 1) / (c + k - 1) / k * x)
        return (serie, term), done | ~(term.abs() > rtol * serie.abs())

    zero = torch.zeros_like(x)
    return _converging(step, (zero, zero + 1.0), torch.zeros_like(x, dtype=torch.bool))[0]


def _hyp2f1_terminal(a, b, c, x):
    # The series ends where a or b is a non-positive integer: sum |a| + 1
    # terms, a the negative integer of larger magnitude (JAX's swap rule).
    eps = torch.finfo(x.dtype).eps * 50
    ib = torch.round(b)
    mask = (b < a) & ((b - ib).abs() < eps) & ~((torch.remainder(c, 1.0) == 0) & (c <= 0) & (c > b))
    a, b = torch.where(mask, b, a), torch.where(mask, a, b)
    a = a.abs()
    serie, term = torch.ones_like(x), torch.ones_like(x)
    stop = int(torch.nan_to_num(a, nan=0.0, posinf=0.0).max()) if a.numel() else 0
    for i in range(1, min(stop, 10**6) + 1):
        live = i < a + 1
        term = torch.where(live, term * (-(a - i + 1) / (c + i - 1) * (b + i - 1) / i * x), term)
        serie = torch.where(live, serie + term, serie)
    return serie


def _hyp2f1_digamma_transform(a, b, c, x):
    # AMS55 15.3.10-15.3.12: the expansion around x = 1 for integer c - a - b.
    rtol = torch.finfo(x.dtype).eps
    dg = torch.special.digamma
    d = c - a - b
    s = 1.0 - x
    rd = torch.round(d)
    e = torch.where(rd >= 0, d, -d)
    d1 = torch.where(rd >= 0, d, 0.0)
    d2 = torch.where(rd >= 0, 0.0, d)
    ard = torch.where(rd >= 0, rd, -rd)
    ax = torch.log(s)
    y = (dg(torch.ones_like(x)) + dg(1.0 + e) - dg(a + d1) - dg(b + d1) - ax) / gamma_fn(e + 1.0)
    p = (a + d1) * (b + d1) * s / gamma_fn(e + 2.0)

    def step(state, t, done):
        y, p = state
        r = dg(1.0 + t + 0.0 * x) + dg(1.0 + t + e) - dg(a + t + d1) - dg(b + t + d1) - ax
        q = p * r
        y = torch.where(done, y, y + q)
        p_next = p * s * (a + t + d1) / (t + 1.0) * (b + t + d1) / (t + 1.0 + e)
        p = torch.where(done, p, p_next)
        return (y, p), done | ~(q.abs() >= rtol * y.abs())

    # JAX's loop tests the first q (= y) before any trip.
    y, _ = _converging(step, (y, p), ~(y.abs() >= rtol * y.abs()))
    y1, t, p = torch.ones_like(x), torch.zeros_like(x), torch.ones_like(x)
    stop = int(torch.nan_to_num(ard, nan=0.0, posinf=0.0).max()) if ard.numel() else 0
    for i in range(1, min(stop, 10**6)):
        live = i < ard
        r = 1.0 - e + t
        p_next = p * s * (a + t + d2) * (b + t + d2) / r / (t + 1.0)
        p = torch.where(live, p_next, p)
        y1 = torch.where(live, y1 + p_next, y1)
        t = torch.where(live, t + 1.0, t)
    gc = gamma_fn(c)
    y1 = y1 * gamma_fn(e) * gc / (gamma_fn(a + d1) * gamma_fn(b + d1))
    yd = y * gc / (gamma_fn(a + d2) * gamma_fn(b + d2))
    yd = torch.where(torch.remainder(ard, 2.0) != 0, -yd, yd)
    q = s**rd
    summed = torch.where(rd > 0, yd * q + y1, yd + y1 * q)
    return torch.where(rd == 0, y * gc / (gamma_fn(a) * gamma_fn(b)), summed)


def hyp2f1(a, b, c, x):
    """Gauss's hypergeometric function `2F1(a, b; c; x)` for real arguments,
    after JAX's `jax.scipy.special.hyp2f1` case for case (Pearson, Olver &
    Porter 2014): the series, its terminating form, the digamma expansion
    for `x > 0.9` and integer `c - a - b`, and the closed forms at `x = 0`,
    `x = 1`, `b = c` and `a = c`. Each loop runs lane by lane to JAX's
    tolerance; the host reads the lanes' progress every few trips."""
    x = _tensor(x, a)
    a, b, c = (_tensor(t, x) for t in (a, b, c))
    a, b, c, x = torch.broadcast_tensors(a, b, c, x)
    eps = torch.finfo(x.dtype).eps * 50
    d = c - a - b
    s = 1.0 - x
    ca, cb = c - a, c - b
    idd = torch.round(d)

    # The series branch (`_hyp2f1_terminal_or_serie` in JAX), at a point
    # where each of its three forms is defined.
    neg_int_a = (a <= 0) & ((a - torch.round(a)).abs() < eps)
    neg_int_b = (b <= 0) & ((b - torch.round(b)).abs() < eps)
    neg_int = neg_int_a | neg_int_b
    inner = torch.where((x > 0.9) & ~neg_int, torch.where((d - idd).abs() >= eps, 0, 1), torch.where(neg_int, 2, 0))

    def series_branch(a, b, c, x):
        out = torch.zeros_like(x)
        for which, fn in ((0, _hyp2f1_serie), (1, _hyp2f1_digamma_transform), (2, _hyp2f1_terminal)):
            lanes = inner_now == which
            if bool(lanes.any()):
                out = torch.where(lanes, fn(*(torch.where(lanes, t, safe) for t, safe in
                                              zip((a, b, c, x), safe_args[which]))), out)
        return out

    index = torch.where(
        (x == 0) | (((a == 0) | (b == 0)) & (c != 0)), 0,
        torch.where((c == 0) | ((c < 0) & (torch.remainder(c, 1.0) == 0)), 1,
        torch.where((d <= -1) & ~(((d - idd).abs() >= eps) & (s < 0)), 2,
        torch.where((d <= 0) & (x == 1), 1,
        torch.where((x < 1) & (b == c), 3,
        torch.where((x < 1) & (a == c), 4,
        torch.where(x > 1, 1,
        torch.where(x == 1, 5, 6))))))))
    half = torch.full_like(x, 0.5)
    one = torch.ones_like(x)
    # Safe stand-ins where a form does not apply: a short convergent series.
    safe_args = {0: (one, one, one + 1.0, half), 1: (one, one, one + 3.0, half + 0.45), 2: (-one, one, one + 1.0, half)}
    out = torch.where(index == 0, 1.0, math.inf)
    out = torch.where(index == 3, s ** (-a), out)
    out = torch.where(index == 4, s ** (-b), out)
    out = torch.where(index == 5, gamma_fn(c) * gamma_fn(d) / (gamma_fn(ca) * gamma_fn(cb)), out)
    # Index 2 (d <= -1) evaluates the series at (c-a, c-b, c, x) times s^d.
    inner_now = inner
    if bool((index == 6).any()):
        out = torch.where(index == 6, series_branch(a, b, c, x), out)
    if bool((index == 2).any()):
        neg_int_ca = (ca <= 0) & ((ca - torch.round(ca)).abs() < eps)
        neg_int_cb = (cb <= 0) & ((cb - torch.round(cb)).abs() < eps)
        neg2 = neg_int_ca | neg_int_cb
        dd = c - ca - cb
        inner_now = torch.where((x > 0.9) & ~neg2, torch.where((dd - torch.round(dd)).abs() >= eps, 0, 1),
                                torch.where(neg2, 2, 0))
        out = torch.where(index == 2, s**d * series_branch(ca, cb, c, x), out)
    return out
