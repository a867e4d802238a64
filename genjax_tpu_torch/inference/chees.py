"""ChEES-HMC: trajectory-length adaptation across a chain batch.

Counterpart of `genjax_tpu/inference/chees.py`: `ChEESResult`,
`chees_warmup` and `run_chees_chains` (Hoffman, Radul & Sountsov, AISTATS
2021). One trajectory length T, shared by the chains, is adapted by Adam
ascent on the Change in the Estimator of the Expected Square,

    ChEES(T) = 1/4 * E[ (||q' - mu||^2 - ||q - mu||^2)^2 ],

whose gradient the batch estimates: per chain
`Delta_i * <q'_i - mu, M^-1 p'_i> * t` (t = u * T), weighted by the
acceptance probabilities. Each iteration draws one shared jitter u ~ U(0, 1)
and runs every chain for `ceil(u * T / eps)` leapfrog steps; the step size
co-adapts by dual averaging toward 0.651, the mass matrix comes from the
cross-chain variance (`inference.adaptation`).

The leapfrog count depends on the adapted state (T and eps live on the
device), and an eager loop needs its trip count on the host: each
iteration reads it once. That is one device synchronisation per ChEES
step, where JAX runs a `fori_loop` with a traced bound and reads nothing.
Everything else (the gradient estimate, Adam, dual averaging, the clip of
log T) stays on the device.

Over a sharded chain axis (`mesh=`), each rank moves its own chains on its
fork of the replicated generator, and the statistics of the batch are
global (`adaptation.ChainShards`): the chain mean of the end points, the
weights' normaliser and the weighted sum of the gradient estimate, and the
mean acceptance, as all-reduced float64 sums. The shared jitter u, which
sets the leapfrog count that every rank reads on the host, comes from the
replicated generator itself, so every rank runs the same trajectory
length; the momenta, the accept uniforms and the chains' draws come from
the rank's fork.
"""

import math
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import Selection
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import batched_mask
from genjax_tpu_torch.core.gfi import Trace, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.core.typing import FloatArray
from genjax_tpu_torch.inference.adaptation import (
    ChainShards,
    DenseChains,
    _split_like,
    accept_probability,
    chain_statistics,
    chain_streams,
    da_final,
    da_init,
    da_update,
    phase_lengths,
)
from genjax_tpu_torch.inference.map_laplace import adam
from genjax_tpu_torch.inference.requests.hmc import (
    _mass_leaves,
    _per_leaf,
    assess_momenta,
    make_selection_grad_fn,
    sample_momenta,
)

__all__ = ["ChEESResult", "chees_warmup", "run_chees_chains"]

# "leapfrog": the last ChEES step's leapfrog count; "syncs" and
# "leapfrog_total": the host reads and the leapfrog steps of every ChEES
# step so far (a caller takes differences).
chees_stats: dict = {"leapfrog": 0, "syncs": 0, "leapfrog_total": 0}


def _leapfrog_n(grad_fn, spec, values, grads, momenta, im, eps, n_steps: int):
    """`n_steps` leapfrog steps over leaf lists (a Python loop)."""
    v, g, m = values, grads, momenta
    for _ in range(n_steps):
        m = [mi + (eps_i / 2) * gi for mi, gi, eps_i in zip(m, g, eps)]
        v = [vi + eps_i * imi * mi for vi, mi, eps_i, imi in zip(v, m, eps, im)]
        _, gradient = grad_fn(pytree.tree_unflatten(v, spec))
        g = pytree.tree_leaves(gradient)
        m = [mi + (eps_i / 2) * gi for mi, gi, eps_i in zip(m, g, eps)]
    return v, g, m


def hmc_step_with(rng, tr, selection, eps, n_steps: int, inv_mass, momenta, log_u):
    """One HMC step over the chain batch from given momenta (a choice map
    like the selected values) and log accept uniforms `(C,)`: the
    deterministic core of a ChEES iteration. Returns the new trace and
    `(accept_prob, q_start, q_end, p_end)`, the last three as choice
    maps."""
    argdiffs = Diff.no_change(tr.get_args())
    grad_fn = make_selection_grad_fn(selection, tr, argdiffs)
    values = tr.get_choices().filter(selection)
    v0, spec, bits = batched_mask(values)
    im = _mass_leaves(inv_mass, v0)
    steps = [_per_leaf(eps, x, b) for x, b in zip(v0, bits)]
    with torch.no_grad():
        mscore0 = assess_momenta(momenta, inv_mass=inv_mass)
        _, grads = grad_fn(values)
        v, _, m = _leapfrog_n(
            grad_fn, spec, v0, pytree.tree_leaves(grads), pytree.tree_leaves(momenta), im, steps, n_steps
        )
        v_f, m_f = pytree.tree_unflatten(v, spec), pytree.tree_unflatten(m, spec)
        new_tr, _, _, _ = Update(v_f).edit(rng, tr, argdiffs)
        mscore1 = assess_momenta(m_f, mul=-1.0, inv_mass=inv_mass)
        alpha = new_tr.get_score() - tr.get_score() + mscore1 - mscore0
        out = where_tree(log_u < alpha, new_tr, tr)
    return out, (accept_probability(alpha), values, v_f, m_f)


def _hmc_step_collecting(rng, tr, selection, eps, n_steps: int, inv_mass):
    """One jittered-HMC step on every chain: draws the momenta and the
    accept uniforms, then runs `hmc_step_with`."""
    values = tr.get_choices().filter(selection)
    momenta, _ = sample_momenta(rng, values, inv_mass=inv_mass)
    score = tr.get_score()
    log_u = torch.log(torch.rand(score.shape, generator=rng, device=score.device))
    return hmc_step_with(rng, tr, selection, eps, n_steps, inv_mass, momenta, log_u)


def _flat_rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _batch_sq_dist(q, mu) -> torch.Tensor:
    """Per-chain ||q - mu||^2 over every selected leaf: `(C,)`."""
    return sum(
        torch.square(_flat_rows(a - b[None])).sum(1)
        for a, b in zip(pytree.tree_leaves(q), pytree.tree_leaves(mu))
    )


def _batch_dot(a, mu, b, im) -> torch.Tensor:
    """Per-chain <a - mu, im * b> over every selected leaf: `(C,)`."""
    return sum(
        _flat_rows((x - m[None]) * (s * y)).sum(1)
        for x, m, y, s in zip(pytree.tree_leaves(a), pytree.tree_leaves(mu), pytree.tree_leaves(b), im)
    )


def _chees_grad_logT(probs, q0, q1, p1, inv_mass, traj_t) -> torch.Tensor:
    """The acceptance-weighted estimate of d ChEES / d log T from the
    batch. A diverged trajectory ends at inf or NaN with acceptance 0, and
    0 * inf is NaN, so non-finite per-chain terms are zeroed explicitly."""
    finite, safe_q1 = _finite_rows(pytree.tree_leaves(q1))
    mu = [v.mean(0) for v in safe_q1]
    delta = _batch_sq_dist(safe_q1, mu) - _batch_sq_dist(q0, mu)
    im = _mass_leaves(inv_mass, mu)
    per_chain = delta * _batch_dot(safe_q1, mu, p1, im)
    w = torch.where(finite, probs, 0.0)
    w = w / (w.sum() + 1e-12)
    per_chain = torch.where(torch.isfinite(per_chain), per_chain, 0.0)
    grad = (w * per_chain).sum() * traj_t
    return torch.where(torch.isfinite(grad), grad, 0.0)


def _finite_rows(q1_leaves: list) -> tuple[torch.Tensor, list]:
    """Which chains' end points are finite, and the end points with the
    others zeroed (a diverged trajectory ends at inf or NaN)."""
    zeros = [torch.zeros_like(v[0]) for v in q1_leaves]
    finite = torch.isfinite(_batch_sq_dist(q1_leaves, zeros))
    return finite, [torch.where(finite.reshape((-1,) + (1,) * (v.dim() - 1)), v, 0.0) for v in q1_leaves]


def chees_statistics(stats: DenseChains | ChainShards, collected: list, inv_mass, traj_t):
    """`(d ChEES / d log T, mean accept probability)` of a ChEES step:
    `collected` holds each block's `(probs, q0, q1, p1)`. On one batch,
    `_chees_grad_logT` and the float32 mean. Over a sharded batch, two
    global float64 sums: the end points' sum (for their mean), then one
    4-vector per block (the weights' sum, the weighted sum of the per-chain
    terms, the accept probabilities' sum and count)."""
    if isinstance(stats, DenseChains):
        probs, q0, q1, p1 = collected[0]
        return _chees_grad_logT(probs, q0, q1, p1, inv_mass, traj_t), probs.mean()
    shards = stats
    rows = []
    for probs, q0, q1, p1 in collected:
        finite, safe_q1 = _finite_rows(pytree.tree_leaves(q1))
        rows.append((probs, q0, safe_q1, p1, finite))
    sums = shards.total([torch.cat([v.double().sum(0).reshape(-1) for v in r[2]]) for r in rows])
    mu = [m.float() for m in _split_like(sums / shards.n_chains, [v[0] for v in rows[0][2]])]
    im = _mass_leaves(inv_mass, mu)
    parts = []
    for probs, q0, safe_q1, p1, finite in rows:
        delta = _batch_sq_dist(safe_q1, mu) - _batch_sq_dist(q0, mu)
        per_chain = delta * _batch_dot(safe_q1, mu, p1, im)
        w = torch.where(finite, probs, 0.0).double()
        per_chain = torch.where(torch.isfinite(per_chain), per_chain, 0.0).double()
        parts.append(torch.stack([w.sum(), (w * per_chain).sum(), probs.double().sum(),
                                  probs.new_full((), probs.numel(), dtype=torch.float64)]))
    total = shards.total(parts)
    grad = (total[1] / (total[0] + 1e-12)).float() * traj_t
    return torch.where(torch.isfinite(grad), grad, 0.0), (total[2] / total[3]).float()


class _Adam:
    """Adam ascent on the scalar log T: `map_laplace.adam` (optax's
    formula) on a one-tensor list, stepped on the negated gradient."""

    _optimizer = adam(0.05)

    def __init__(self, state: tuple):
        self.state = state

    @staticmethod
    def init(device=None) -> "_Adam":
        return _Adam(_Adam._optimizer.init([torch.zeros((), device=device)]))

    def step(self, grad) -> tuple["_Adam", torch.Tensor]:
        (delta,), state = self._optimizer.update([-grad], self.state)
        return _Adam(state), delta


@Pytree.dataclass
class ChEESResult(Pytree):
    """The tuned kernel: run it with `run_chees_chains(..., result, ...)`
    (or build an `HMC` with `L ~ trajectory_length / (2 * eps)` for a
    fixed-L kernel)."""

    eps: FloatArray
    trajectory_length: FloatArray
    inv_mass: Any
    accept_rate: FloatArray


def _leapfrog_count(u, T, eps, max_leapfrog: int) -> int:
    """`clip(ceil(u * T / eps), 1, max_leapfrog)`, read on the host: the
    one device synchronisation of a ChEES step."""
    n = torch.clamp(torch.ceil(u * T / eps).to(torch.int32), 1, max_leapfrog)
    chees_stats["leapfrog"] = int(n)
    chees_stats["syncs"] += 1
    chees_stats["leapfrog_total"] += chees_stats["leapfrog"]
    return chees_stats["leapfrog"]


def _chees_phase(rng, streams, blocks, stats, selection, inv_mass, da, logT, opt, n_steps, target, max_leapfrog):
    """`n_steps` ChEES steps: u from `rng` (one draw every block shares),
    each block's HMC step from its own generator, the statistics of
    `stats`."""
    device = blocks[0].get_score().device
    hist = []
    for _ in range(n_steps):
        eps = torch.exp(da.log_eps)
        u = torch.rand((), generator=rng, device=device)
        traj_t = u * torch.exp(logT)
        n_leap = _leapfrog_count(u, torch.exp(logT), eps, max_leapfrog)
        moved = [_hmc_step_collecting(g, tr, selection, eps, n_leap, inv_mass) for g, tr in zip(streams, blocks)]
        blocks = [tr for tr, _ in moved]
        grad, mean_prob = chees_statistics(stats, [c for _, c in moved], inv_mass, traj_t)
        opt, delta = opt.step(grad)
        logT = torch.clamp(logT + delta, math.log(1e-2), math.log(1e3))
        da = da_update(da, mean_prob, target=target)
        hist.append(mean_prob)
    return blocks, da, logT, opt, torch.stack(hist)


def chees_blocks(
    rng: torch.Generator,
    streams: list[torch.Generator],
    blocks: list[Trace[Any]],
    stats: DenseChains | ChainShards,
    selection: Selection,
    n_steps: int,
    *,
    eps0: float = 0.1,
    T0: float = 1.0,
    target_accept: float = 0.651,
    adapt_mass: bool = True,
    max_leapfrog: int = 1024,
) -> tuple[list[Trace[Any]], ChEESResult]:
    """`chees_warmup`'s schedule: `blocks[i]` moves on `streams[i]`, the
    shared jitter comes from `rng`, and every statistic is `stats`' (of
    the one batch, or global over a sharded chain axis: a rank's own block,
    or every rank's block in the stitched dense reference). A new metric
    restarts the step size and keeps T (its optimum moves less than the
    stability limit does)."""
    device = blocks[0].get_score().device
    n1, n2, n3 = phase_lengths(n_steps)
    da = da_init(eps0, device)
    logT = torch.full((), math.log(T0), device=device)
    opt = _Adam.init(device)
    inv_mass = None
    blocks, da, logT, opt, _ = _chees_phase(
        rng, streams, blocks, stats, selection, inv_mass, da, logT, opt, n1, target_accept, max_leapfrog
    )
    if adapt_mass:
        inv_mass = stats.inv_mass(blocks, selection)
        da = da_init(1.0, device)
    blocks, da, logT, opt, _ = _chees_phase(
        rng, streams, blocks, stats, selection, inv_mass, da, logT, opt, n2, target_accept, max_leapfrog
    )
    if adapt_mass:
        inv_mass = stats.inv_mass(blocks, selection)
    blocks, da, logT, opt, accept_hist = _chees_phase(
        rng, streams, blocks, stats, selection, inv_mass, da, logT, opt, n3, target_accept, max_leapfrog
    )
    return blocks, ChEESResult(
        eps=da_final(da), trajectory_length=torch.exp(logT), inv_mass=inv_mass, accept_rate=accept_hist.mean()
    )


def chees_warmup(
    rng: torch.Generator,
    traces: Trace[Any],
    selection: Selection,
    n_steps: int = 300,
    *,
    eps0: float = 0.1,
    T0: float = 1.0,
    target_accept: float = 0.651,
    adapt_mass: bool = True,
    max_leapfrog: int = 1024,
    n_chains: int | None = None,
    mesh=None,
    axis: str = "chains",
) -> tuple[Trace[Any], ChEESResult]:
    """Adapt the step size, the trajectory length and (with `adapt_mass`)
    the diagonal mass matrix of a chain batch, with the phase schedule of
    `adaptation.warmup_chains`. `max_leapfrog` caps an iteration's work
    while T explores. One host read per step (the leapfrog count).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.chees import chees_warmup
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 2.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> rng = torch.Generator().manual_seed(0)
    >>> trs, _ = model.importance(rng, gx.ChoiceMap.kw(obs=1.0), (), n=64)
    >>> warmed, res = chees_warmup(rng, trs, gx.Selection.at["mu"], n_steps=60)
    >>> bool(res.eps > 0), bool(res.trajectory_length > 0)
    (True, True)

    With `mesh`, `traces` are this rank's chains of a batch whose chain
    axis spans the mesh's `axis` (`n_chains`, where given, the global
    count): the rank's chains draw from `fork(rng, n)[rank]`, u from `rng`
    itself, every statistic is global, and every rank returns its own
    warmed chains with the same result.
    """
    stats = chain_statistics(traces, n_chains, mesh, axis)
    (traces,), result = chees_blocks(
        rng, chain_streams(rng, mesh, axis), [traces], stats, selection, n_steps, eps0=eps0, T0=T0,
        target_accept=target_accept, adapt_mass=adapt_mass, max_leapfrog=max_leapfrog,
    )
    return traces, result


def run_chees_chains(
    rng: torch.Generator,
    traces: Trace[Any],
    selection: Selection,
    result: ChEESResult,
    n_steps: int,
    collect: Callable[[Trace[Any]], Any] | None = None,
    max_leapfrog: int = 1024,
    n_chains: int | None = None,
):
    """Sample with the tuned jittered-HMC kernel (the one the warmup
    optimized): each iteration draws one shared u ~ U(0, 1) and runs every
    chain for `ceil(u * T / eps)` leapfrog steps. Returns the final traces
    and the per-step statistic stacked along a leading step axis: the
    batch's mean accept probability, or `collect(traces)`. One host read
    per step."""
    eps, T, inv_mass = result.eps, result.trajectory_length, result.inv_mass
    device = traces.get_score().device
    out = []
    for _ in range(n_steps):
        u = torch.rand((), generator=rng, device=device)
        n_leap = _leapfrog_count(u, T, eps, max_leapfrog)
        traces, (probs, _, _, _) = _hmc_step_collecting(rng, traces, selection, eps, n_leap, inv_mass)
        out.append(collect(traces) if collect is not None else probs.mean())
    return traces, pytree.tree_map(lambda *xs: torch.stack(xs), *out)
