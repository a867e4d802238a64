"""Joint-distribution validation of inference kernels: simulation-based
calibration (SBC) and Geweke's "getting it right" test.

Counterpart of `genjax_tpu/inference/validation.py`: `sbc`, `SBCResult`,
`geweke` and `GewekeResult`.

- SBC (Talts et al. 2018): draw `(theta, y) ~ p` with `simulate`, run the
  kernel on `p(theta | y)` from the prior draw, and record the rank of
  `g(theta_prior)` among the chain's draws; a kernel that leaves the
  posterior invariant gives uniform ranks for every summary `g`.
- Geweke (2004): forward draws `(theta, y) ~ p` against a chain that
  alternates the kernel with an MH-corrected `Regenerate` of the
  observations; both have the same stationary joint iff the kernel is
  right, and moment z-scores (with the chain's ESS) show where not.

The replicates (chains) are one batch made with a particle count; the
draw loop is a Python loop, ranks accumulate as it goes, and ties are
broken by iid uniforms, so discrete summaries rank correctly.
"""

from typing import Any, Callable

import torch

from genjax_tpu_torch.core.choice_map import Choice, Selection
from genjax_tpu_torch.core.concepts import EditRequest
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.mask import Mask
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.core.typing import FloatArray, as_float, plain
from genjax_tpu_torch.inference.diagnostics import effective_sample_size
from genjax_tpu_torch.inference.mcmc import mh

__all__ = ["GewekeResult", "SBCResult", "geweke", "sbc"]


def _as_kernel(kernel) -> Callable[[torch.Generator, Trace[Any]], Trace[Any]]:
    """An `(rng, trace) -> trace` callable as it is; an `EditRequest`
    wrapped in one MH step."""
    if isinstance(kernel, EditRequest):
        request = kernel

        def step(rng: torch.Generator, trace: Trace[Any]) -> Trace[Any]:
            return mh(rng, trace, request)[0]

        return step
    return kernel


def _flat_summaries(selection: Selection, with_squares: bool):
    """The default summaries: the selected numeric values of each chain,
    flattened into one row (with their squares appended, so that second
    moments are checked too): `(n_chains, S)`."""

    def g(trace: Trace[Any]) -> FloatArray:
        n = trace.particle_count()
        choices = []

        def visit(c: Choice) -> Choice:
            choices.append(c)
            return c

        trace.get_choices().filter(selection).map_choices(visit)
        rows = []
        for c in choices:
            v, depth = c.v, c.batched
            if isinstance(v, Mask):
                if not isinstance(v.flag, bool):
                    raise ValueError(
                        "validation: the selection produced a runtime-valued Mask; pass an explicit "
                        "`summaries` function."
                    )
                if not v.flag:
                    continue
                v = v.value
            v = plain(v)
            if v.dtype == torch.bool:
                continue
            v = as_float(v)
            if n is None:
                rows.append(v.reshape(-1))
            elif depth:
                rows.append(v.reshape(n, -1))
            else:
                rows.append(v.reshape(1, -1).expand(n, -1))
        if not rows:
            raise ValueError("validation: the selection matched no numeric choices; pass an explicit `summaries`.")
        flat = torch.cat(rows, dim=-1)
        return torch.cat([flat, torch.square(flat)], dim=-1) if with_squares else flat

    return g


def _thinned(kernel, thin: int):
    def sweep(rng: torch.Generator, trace: Trace[Any]) -> Trace[Any]:
        for _ in range(thin):
            trace = kernel(rng, trace)
        return trace

    return sweep


@Pytree.dataclass
class SBCResult(Pytree):
    """SBC ranks: `ranks[r, s]` is the rank (in `{0..n_draws}`) of
    replicate `r`'s prior summary `s` among its chain draws; uniform in
    every column under a correct kernel."""

    ranks: Any
    n_draws: int = Pytree.static()

    def histogram(self, n_bins: int | None = None):
        """Binned rank counts, `(n_summaries, n_bins)`."""
        n_bins = self._n_bins(n_bins)
        edges = self.ranks.to(torch.int64) * n_bins // (self.n_draws + 1)
        return torch.nn.functional.one_hot(edges, n_bins).to(torch.float32).sum(0)

    def uniformity(self, n_bins: int | None = None):
        """Per-summary chi-square test of the rank histogram against the
        bins' actual widths: `(statistic, p_value)`, each
        `(n_summaries,)`."""
        n_bins = self._n_bins(n_bins)
        counts = self.histogram(n_bins)
        rank_bins = torch.arange(self.n_draws + 1, device=counts.device) * n_bins // (self.n_draws + 1)
        widths = torch.nn.functional.one_hot(rank_bins, n_bins).to(torch.float32).sum(0)
        total = counts.sum(-1, keepdim=True)
        expected = total * widths / (self.n_draws + 1)
        stat = (torch.square(counts - expected) / expected).sum(-1)
        df = torch.full_like(stat, (n_bins - 1) / 2.0)
        return stat, 1.0 - torch.special.gammainc(df, stat / 2.0)

    def _n_bins(self, n_bins: int | None) -> int:
        if n_bins is None:
            n_bins = min(self.n_draws + 1, 20)
        if not 2 <= n_bins <= self.n_draws + 1:
            raise ValueError(f"SBCResult: n_bins={n_bins} must lie in [2, n_draws + 1 = {self.n_draws + 1}].")
        return n_bins


def sbc(
    rng: torch.Generator,
    model: GenerativeFunction,
    args: tuple,
    latents: Selection,
    kernel,
    *,
    n_replicates: int,
    n_draws: int,
    thin: int = 1,
    summaries: Callable[[Trace], FloatArray] | None = None,
) -> SBCResult:
    """Simulation-based calibration of a posterior kernel.

    `kernel` is an `EditRequest` (one MH step per application) or an
    `(rng, trace) -> trace` callable that leaves `p(latents | rest)`
    invariant over a batch of chains. `thin` applications separate two
    recorded draws. `summaries(trace)` returns `(n_replicates, S)`.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.validation import sbc
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> res = sbc(torch.Generator().manual_seed(0), model, (), gx.Selection.at["mu"],
    ...     gx.Regenerate(gx.Selection.at["mu"]), n_replicates=64, n_draws=9, thin=2)
    >>> res.ranks.shape  # 64 replicates x (mu,) summaries
    torch.Size([64, 1])
    >>> bool(((res.ranks >= 0) & (res.ranks <= 9)).all())
    True
    """
    g = summaries if summaries is not None else _flat_summaries(latents, False)
    sweep = _thinned(_as_kernel(kernel), thin)
    traces = model.simulate(rng, args, n=n_replicates)
    g0 = g(traces)
    u0 = torch.rand(g0.shape, generator=rng, device=g0.device)
    ranks = torch.zeros(g0.shape, dtype=torch.int32, device=g0.device)
    for _ in range(n_draws):
        traces = sweep(rng, traces)
        gd = g(traces)
        ud = torch.rand(gd.shape, generator=rng, device=gd.device)
        # Lexicographic (value, iid uniform) comparison: exact for
        # continuous summaries, randomized tie-breaking for discrete ones.
        ranks = ranks + ((gd < g0) | ((gd == g0) & (ud < u0))).to(torch.int32)
    return SBCResult(ranks=ranks, n_draws=n_draws)


@Pytree.dataclass
class GewekeResult(Pytree):
    """Per-summary moment z-scores between the forward sampler and the
    successive-conditional chain (|z| beyond about 4-5 flags a bug), the
    two means and the chain's ESS."""

    z_scores: FloatArray
    mean_forward: FloatArray
    mean_chain: FloatArray
    ess: FloatArray

    def max_abs_z(self) -> FloatArray:
        return self.z_scores.abs().max()


def geweke(
    rng: torch.Generator,
    model: GenerativeFunction,
    args: tuple,
    latents: Selection,
    kernel,
    *,
    n_forward: int,
    n_steps: int,
    n_chains: int = 8,
    thin: int = 1,
    summaries: Callable[[Trace], FloatArray] | None = None,
) -> GewekeResult:
    """Geweke's joint-distribution test: `n_forward` forward draws of the
    summaries against `n_chains` successive-conditional chains of
    `n_steps` sweeps, each `thin` kernel applications followed by an
    MH-corrected `Regenerate(~latents)` refresh of the data. The default
    summaries are every numeric choice and its square. The chain side's
    standard error uses the multi-chain ESS.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.validation import geweke
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> res = geweke(torch.Generator().manual_seed(0), model, (), gx.Selection.at["mu"],
    ...     gx.Regenerate(gx.Selection.at["mu"]), n_forward=512, n_steps=64, n_chains=4)
    >>> res.z_scores.shape  # (mu, y) and their squares
    torch.Size([4])
    """
    g = summaries if summaries is not None else _flat_summaries(Selection.all(), True)
    latent_sweep = _thinned(_as_kernel(kernel), thin)
    refresh = _as_kernel(Regenerate(~latents))

    gf = g(model.simulate(rng, args, n=n_forward))
    traces = model.simulate(rng, args, n=n_chains)
    gs = []
    for _ in range(n_steps):
        traces = refresh(rng, latent_sweep(rng, traces))
        gs.append(g(traces))
    gs = torch.stack(gs, dim=1)  # (n_chains, n_steps, S)

    mean_f = gf.mean(0)
    var_f = gf.var(0, correction=1)
    mean_c = gs.mean((0, 1))
    var_c = gs.reshape(-1, gs.shape[-1]).var(0, correction=1)
    ess = effective_sample_size(gs)
    z = (mean_f - mean_c) / torch.sqrt(var_f / n_forward + var_c / ess)
    return GewekeResult(z_scores=z, mean_forward=mean_f, mean_chain=mean_c, ess=ess)
