"""Nested sampling: model-evidence estimation with live-point shrinkage
(Skilling 2006).

Counterpart of `genjax_tpu/inference/nested.py`. The sampler keeps
`n_live` prior draws ("live points"); each iteration retires the one with
the lowest likelihood (banking it against the deterministic prior-volume
shrinkage X_i = exp(-i/N)) and replaces it with a draw from the prior
constrained to exceed that likelihood, by a constrained random walk from a
surviving live point.

GFI mapping, as in JAX: a trace's likelihood is its score less the
projection on the latent selection (the prior term), and the walk is an
`Update` edit accepted on the prior ratio under the hard likelihood
constraint. JAX's two `lax.scan`s are loops with a fixed trip count here;
every step stays on the device (argmin, gathers, the walk's selects, the
write-back), with no host read. The evidence's log-sum-exp goes through
`ops.logsumexp`, the CUDA kernel on the card. The walk carries the
current point's prior term instead of projecting it anew each step.
"""

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import batched_mask, take_row
from genjax_tpu_torch.core.gfi import GenerativeFunction, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.inference.sp import stack_runs
from genjax_tpu_torch.ops import logsumexp

__all__ = ["NestedSampler", "evidence"]


def _put_row(batch, row: torch.Tensor, single):
    """`batch` (a trace with a particle axis) with particle `row` (a 0-d
    index tensor) replaced by the one-particle trace `single`."""
    leaves, spec, bits = batched_mask(batch)
    new = pytree.tree_leaves(single)
    if len(new) != len(leaves):
        raise ValueError("_put_row: the trace and the batch differ in structure")
    out = [v.index_copy(0, row.reshape(1), s.unsqueeze(0)) if b else v for v, s, b in zip(leaves, new, bits)]
    return pytree.tree_unflatten(out, spec)


def evidence(dead_logliks: torch.Tensor, live_logliks: torch.Tensor, n_live: int) -> tuple:
    """`(lml, log_dead_terms, log_remainder)`: the dead shells weighted by
    the shrinkage `X_{i-1} - X_i` (X_i = exp(-i/N)), and the live points
    each by the final volume X_T / N."""
    n_iters = dead_logliks.shape[0]
    i = torch.arange(1, n_iters + 1, dtype=torch.float32, device=dead_logliks.device)
    log_x = -i / float(n_live)
    log_prev = torch.cat([torch.zeros(1, device=log_x.device), log_x[:-1]])
    log_w = log_prev + math.log1p(-math.exp(-1.0 / float(n_live)))
    log_dead = dead_logliks + log_w
    log_live = live_logliks + (-n_iters / float(n_live)) - math.log(float(n_live))
    return logsumexp(torch.cat([log_dead, log_live])), log_dead, logsumexp(log_live)


@Pytree.dataclass
class NestedSampler(Pytree):
    """Nested sampling over the continuous latents that `selection` picks
    out of `model(*args)` given `observations`.

    `n_live` live points, `n_iters` retirements (choose `n_iters >~ n_live
    * H` for information H in nats; `remainder_frac` diagnoses
    truncation), `n_mcmc` constrained random-walk steps per replacement
    with per-leaf scale `step_scale`.

    `run(rng)` returns a dict: `lml` (the evidence, with the final live
    remainder), `dead_choices` / `dead_logliks` / `log_post_weights` (the
    retired points and their posterior importance weights), `accept_rate`,
    `remainder_frac` and `live_logliks`. The points live where `rng` does.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.nested import NestedSampler
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 0.5) @ "y"
    >>> ns = NestedSampler(model, (), gx.ChoiceMap.kw(y=1.0), gx.Selection.at["x"], n_live=50, n_iters=100, n_mcmc=5)
    >>> out = ns.run(torch.Generator().manual_seed(0))
    >>> bool(torch.isfinite(out["lml"]))
    True
    """

    model: GenerativeFunction[Any]
    args: tuple
    observations: ChoiceMap
    selection: Selection
    n_live: int = Pytree.static(default=500)
    n_iters: int = Pytree.static(default=2000)
    n_mcmc: int = Pytree.static(default=20)
    step_scale: Any = 0.5

    def _prior(self, rng, trace) -> torch.Tensor:
        return trace.project(rng, self.selection)

    def _constrained_walk(self, rng, trace, loglik, prior, lstar, argdiffs):
        """`n_mcmc` random-walk steps invariant for the prior restricted to
        `{loglik > lstar}`: propose `values + step_scale * xi`, accept on
        the prior ratio AND the likelihood constraint."""
        n_acc = torch.zeros((), dtype=torch.int32, device=rng.device)
        for _ in range(self.n_mcmc):
            values = trace.get_choices().filter(self.selection)
            proposed = values.map_choices(
                lambda c: type(c).build(
                    c.v + self.step_scale * torch.randn(c.v.shape, generator=rng, device=rng.device), c.batched
                )
            )
            cand, _, _, _ = Update(proposed).edit(rng, trace, argdiffs)
            cand_prior = self._prior(rng, cand)
            cand_ll = cand.get_score() - cand_prior
            u = torch.rand((), generator=rng, device=rng.device)
            accept = (torch.log(u) < cand_prior - prior) & (cand_ll > lstar)
            trace = where_tree(accept, cand, trace)
            loglik = torch.where(accept, cand_ll, loglik)
            prior = torch.where(accept, cand_prior, prior)
            n_acc = n_acc + accept
        return trace, loglik, prior, n_acc

    def run(self, rng: torch.Generator) -> dict:
        n = self.n_live
        live, _ = self.model.importance(rng, self.observations, self.args, n=n)
        priors = self._prior(rng, live).expand(n)
        logliks = live.get_score() - priors
        argdiffs = Diff.no_change(self.args)
        dead, dead_ll, n_accs = [], [], []
        for _ in range(self.n_iters):
            worst = torch.argmin(logliks)
            lstar = logliks[worst]
            dead.append(take_row(live, worst).get_choices().filter(self.selection))
            dead_ll.append(lstar)
            # Clone a surviving point (never the worst itself) and walk it
            # within the constrained prior.
            offset = torch.randint(1, n, (), generator=rng, device=rng.device)
            donor = (worst + offset) % n
            new_tr, new_ll, new_prior, n_acc = self._constrained_walk(
                rng, take_row(live, donor), logliks[donor], priors[donor], lstar, argdiffs
            )
            live = _put_row(live, worst, new_tr)
            logliks = logliks.index_copy(0, worst.reshape(1), new_ll.reshape(1))
            priors = priors.index_copy(0, worst.reshape(1), new_prior.reshape(1))
            n_accs.append(n_acc)
        dead_ll = torch.stack(dead_ll)
        lml, log_dead, remainder = evidence(dead_ll, logliks, n)
        return {
            "lml": lml,
            "dead_choices": stack_runs(dead),
            "dead_logliks": dead_ll,
            "log_post_weights": log_dead - lml,
            "accept_rate": (torch.stack(n_accs).float() / float(self.n_mcmc)).mean(),
            "remainder_frac": torch.exp(remainder - lml),
            "live_logliks": logliks,
        }
