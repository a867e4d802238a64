"""Data-sharded likelihoods: a model's observations split over the ranks
of a mesh axis, its chains or particles whole on every rank.

Counterpart of JAX's sharded data operand under GSPMD
(`tests/parallel/test_data_sharded.py`): JAX places the design matrix
with `NamedSharding(mesh, P("data", None))` and XLA partitions the
likelihood, inserting the all-reduces of the per-chain scores and of the
gradient. Here each rank holds its own rows of the data (the design matrix
through `share_chain_args`, the observations in the constraint), and
`data_sharded(model, mesh, sites)` is the same model, its body untouched,
whose named sites score this rank's rows and sum the scores over the
axis. Every other site (the prior on the weights) is scored once, on every
rank alike.

The mechanism is a handler in the `@gen` language: the returned function's
source runs the model's source under `_SiteSharding`, which hands the
method's own handler a `ShardedSite` in place of the distribution at each
named site. The site's score is all-reduced wherever a score is formed
(`simulate`, `assess`, `generate`/`importance`, the `Update` and
`Regenerate` edits, the edit plan's per-site weights, `StaticRequest`),
so every trace holds the global score, every weight is the global one, and
an MH ratio reads the whole likelihood on every rank.

The gradient. Autograd on a rank sees only its own partial `l_r`, and the
model's gradient is `grad prior + sum_r grad l_r`. As `shard_map` does, the
replicated values meet the rank-local computation through an identity
whose backward reduces the cotangent over the axis: here every value that
the body receives (a site's value, a replicated argument) passes
`_MeanGrad`, whose backward is the mean of the ranks' cotangents, and the
named site's all-reduce passes its cotangent back multiplied by the axis
size (the cotangent of a replicated sum is the same on every rank, so this
is the all-reduce of the cotangents without a collective). A replicated
path then keeps its gradient (the mean of equal values) and a rank-local
path sums over the ranks: `grad prior + sum_r grad l_r`, exact. The
backward all-reduces one tensor of a value's size, `(C, D)` for C chains
of a D-vector, and the forward one score `(C,)`: no collective is of the
data's size (`collectives.stats()`, the counterpart of JAX's HLO pin).

The replicated chains draw their momenta and accept uniforms from the
replicated generator (no fork), so every rank takes the same decision from
the same all-reduced scores; a fresh draw at a named site (`simulate`, an
unconstrained `generate`, `Regenerate`) comes from the rank's fork of it,
so the ranks' rows are independent. The named sites must be distributions at the
top level of the model, and a gradient with respect to their own
(rank-local) values is not the model's: they hold observations.
"""

from typing import Any

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.staging import SHAPE_RNG
from genjax_tpu_torch.core.typing import depth_of, mark, plain
from genjax_tpu_torch.distributions.distribution import Distribution, DistributionTrace
from genjax_tpu_torch.lang.interop import TraceHandler, current_handler, handler_context
from genjax_tpu_torch.lang.static import StaticGenerativeFunction, gen
from genjax_tpu_torch.parallel import collectives as C
from genjax_tpu_torch.parallel.mesh import Mesh


class _ShardSum(torch.autograd.Function):
    """The sum of the ranks' partials; its backward passes the (replicated)
    cotangent times the axis size."""

    @staticmethod
    def forward(ctx, local, mesh, axis):
        ctx.n = mesh.shape[axis]
        return C.all_reduce(local.clone(memory_format=torch.contiguous_format), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None


class _MeanGrad(torch.autograd.Function):
    """The identity; its backward is the mean of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = C.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.mesh, ctx.axis)
        return total / ctx.mesh.shape[ctx.axis], None, None


def shard_sum(local: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over the ranks along `axis` of a rank-local score (one
    all-reduce), differentiable as set out above."""
    if torch.is_grad_enabled() and local.requires_grad:
        return _ShardSum.apply(local, mesh, axis)
    return C.all_reduce(local.clone(memory_format=torch.contiguous_format), mesh, axis)


def replicated(tree: Any, mesh: Mesh, axis: str) -> Any:
    """`tree` with each leaf that requires a gradient passed through
    `_MeanGrad` (its batch mark kept); anything else as it is."""
    if not torch.is_grad_enabled():
        return tree

    def one(x):
        if not (isinstance(x, torch.Tensor) and x.requires_grad):
            return x
        return mark(_MeanGrad.apply(plain(x), mesh, axis), depth_of(x))

    return pytree.tree_map(one, tree)


@Pytree.dataclass
class ShardedSite(Distribution):
    """The distribution `base` at a site whose value holds this rank's
    rows of the observations: its score is the sum over the ranks along
    `axis` of `base`'s score of each rank's rows. Densities are `base`'s; a fresh
    draw (`simulate`, an unconstrained `generate`, `Regenerate`) is
    `base`'s from the rank's fork of the generator."""

    base: Any
    mesh: Mesh = Pytree.static()
    axis: str = Pytree.static(default="data")

    @property
    def param_event_extra(self):
        return self.base.param_event_extra

    def __abstract_call__(self, *args):
        return self.base.__abstract_call__(*args)

    def random_weighted(self, rng, *args, n=None):
        return self.base.random_weighted(rng, *args, n=n)

    def estimate_logpdf(self, rng, v, *args):
        return self.base.estimate_logpdf(rng, v, *args)

    def _draw(self, rng, args: tuple, n):
        """A fresh draw of this rank's rows: from the rank's fork of the
        replicated generator, so that the ranks' rows are independent."""
        if rng is not SHAPE_RNG:
            rng = fork(rng, self.mesh.shape[self.axis])[self.mesh.rank(self.axis)]
        return self.base._draw(rng, args, n)

    def _density(self, rng, v, args: tuple, depth: int = 0):
        return self.base._density(rng, v, args, depth)

    def _trace(self, args: tuple, value, density, batched: int) -> DistributionTrace:
        tr = self.base._trace(args, value, density, batched)
        return DistributionTrace(self, tr.args, tr.value, shard_sum(tr.score, self.mesh, self.axis), tr.batched)

    def assess(self, sample, args: tuple, n=None, marked: bool = False):
        score, v = self.base.assess(sample, args, n, marked)
        return shard_sum(score, self.mesh, self.axis), v


class _SiteSharding(TraceHandler):
    """Forwards each site to the method's handler (`outer`): a named site
    with its distribution wrapped in `ShardedSite`, every other site as it
    is, its value handed to the body through `replicated`."""

    def __init__(self, outer: TraceHandler, sites: frozenset, mesh: Mesh, axis: str):
        self.outer, self.sites, self.mesh, self.axis = outer, sites, mesh, axis

    def handle_trace(self, addr, gen_fn, args):
        if addr in self.sites:
            if not isinstance(gen_fn, Distribution):
                raise TypeError(f"data_sharded: the site {addr!r} is a {type(gen_fn).__name__}, not a distribution")
            return self.outer.handle_trace(addr, ShardedSite(gen_fn, self.mesh, self.axis), args)
        return replicated(self.outer.handle_trace(addr, gen_fn, args), self.mesh, self.axis)


def data_sharded(
    model: StaticGenerativeFunction, mesh: Mesh, sites, axis: str = "data", data_args: tuple = ()
) -> StaticGenerativeFunction:
    """`model` with the observations of `sites` (top-level addresses of
    distribution sites) split over the ranks along `axis`: call it with this
    rank's rows of the data (the arguments at the positions `data_args`,
    and the observed values in the constraint) and with every other
    argument and the chains whole. Every score and weight is the global
    one, the same on every rank. Make it once and reuse it: its traces
    hold it. On every rank of a mesh with a `"data"` axis:

        model = data_sharded(logistic_regression, mesh, ["ys"], data_args=(0,))
        traces, w = model.importance(rng, ChoiceMap.kw(ys=ys_rows), (X_rows,), n=C)
    """
    inner = model.source
    sites = frozenset(sites)
    data_args = frozenset(data_args)

    def source(*args):
        args = tuple(a if i in data_args else replicated(a, mesh, axis) for i, a in enumerate(args))
        with handler_context(_SiteSharding(current_handler(), sites, mesh, axis)):
            return inner(*args)

    source.__name__ = source.__qualname__ = f"data_sharded({getattr(model, '__name__', 'model')})"
    return gen(source)


__all__ = ["ShardedSite", "data_sharded", "replicated", "shard_sum"]
