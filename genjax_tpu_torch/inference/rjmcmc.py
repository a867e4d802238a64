"""Reversible-jump MCMC across `Switch` branches.

Counterpart of `genjax_tpu/inference/rjmcmc.py`. A reversible jump is a
matched pair of directed proposals between two model configurations (two
`Switch` branches of different dimension): each direction reads the
current configuration's parameters, draws auxiliary randomness to pad the
dimension gap, maps both through a differentiable bijection, and writes
the other configuration with one `Update`, whose weight is the ratio of
the joint densities. The acceptance ratio is

    log alpha = w_update + log q_rev(u') - log q_fwd(u) + log |det J|

with the Jacobian of the flat `(params, u) -> (params', u')` map, square
by the dimension-matching condition (checked on the call, before any
Jacobian is taken).

Over a batch of C chains the map is user code on plain tensors, with no
data-dependent control flow: the Jacobian of one chain's flat map is
`torch.func.jacfwd`, batched over the chains by `torch.func.vmap`, a
`(C, d, d)` tensor, then `torch.linalg.slogdet`. As in JAX, both
directions run for every chain and the live one is selected with
`where_tree`.
"""

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import Choice, ChoiceMap
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.core.typing import per_particle, plain

__all__ = ["JumpProposal", "reversible_jump"]


@Pytree.dataclass
class JumpProposal(Pytree):
    """One direction of a reversible jump.

    - `read(choices) -> params`: this configuration's parameters (a pytree
      of tensors) from the model's choices; over a batch of chains, one
      value per chain (the chain axis in front of every leaf).
    - `aux`: the generative function of the auxiliary randomness
      (`aux_args(choices)` builds its arguments; a site-free `@gen`
      function where the direction needs no padding).
    - `involution(params, u_chm) -> (params_other, u_rev_chm)`: the
      differentiable map to the other configuration's parameters and the
      reverse direction's auxiliary choices (dim params + dim u must equal
      dim params_other + dim u_rev).
    - `constraint(params_other) -> ChoiceMap`: the `Update` constraint that
      makes the jump; it sets the branch-index site and every site of the
      newly active configuration.
    """

    read: Callable[[ChoiceMap], Any] = Pytree.static()
    aux: GenerativeFunction[Any] = None
    aux_args: Callable[[ChoiceMap], tuple] = Pytree.static(default=lambda chm: ())
    involution: Callable[[Any, ChoiceMap], tuple[Any, ChoiceMap]] = Pytree.static(default=None)
    constraint: Callable[[Any], ChoiceMap] = Pytree.static(default=None)


def _per_chain(chm: ChoiceMap) -> ChoiceMap:
    """`chm` with every value recorded as one per chain."""
    return chm.map_choices(lambda c: Choice(plain(c.v), 1) if isinstance(c.v, torch.Tensor) else c)


def _flat(leaves: list, n: int | None) -> torch.Tensor:
    """The leaves as one flat vector per chain: `(C, d)`, or `(d,)`."""
    lead = () if n is None else (n,)
    parts = [torch.as_tensor(v).reshape(*lead, -1) for v in leaves]
    return torch.cat(parts, dim=-1) if parts else torch.zeros(*lead, 0)


def _event_shapes(leaves: list, n: int | None) -> list:
    return [tuple(torch.as_tensor(v).shape[0 if n is None else 1 :]) for v in leaves]


def _directed_jump(rng, trace: Trace, fwd: JumpProposal, rev: JumpProposal, argdiffs, aux_tr: Trace | None = None):
    """Propose one direction: (candidate trace, log alpha). `aux_tr` is the
    auxiliary draw's trace (simulated here where not given)."""
    n = trace.particle_count()
    choices = trace.get_choices()
    params = pytree.tree_map(plain, fwd.read(choices))
    if aux_tr is None:
        aux_tr = fwd.aux.simulate(rng, fwd.aux_args(choices), n)
    u = aux_tr.get_choices()
    q_fwd = aux_tr.get_score()

    p_leaves, p_spec = pytree.tree_flatten(params)
    u_leaves, u_spec = pytree.tree_flatten(u)

    # The output structures and sizes come from one evaluation over every
    # chain, which also gives the values the jump writes.
    params_other, u_rev = fwd.involution(params, u)
    po_leaves = pytree.tree_leaves(params_other)
    ur_leaves = pytree.tree_leaves(u_rev)
    d_in = _flat(p_leaves + u_leaves, n).shape[-1]
    d_out = _flat(po_leaves + ur_leaves, n).shape[-1]
    if d_in != d_out:
        raise ValueError(
            f"reversible_jump: dimension mismatch — dim(params) + dim(u) = {d_in} but dim(params') + dim(u') = "
            f"{d_out}; the involution must conserve total dimension."
        )

    shapes = _event_shapes(p_leaves + u_leaves, n)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    n_p = len(p_leaves)

    def f_flat(xu: torch.Tensor) -> torch.Tensor:
        leaves = [part.reshape(shape) for part, shape in zip(torch.split(xu, sizes), shapes)]
        po, ur = fwd.involution(pytree.tree_unflatten(leaves[:n_p], p_spec), pytree.tree_unflatten(leaves[n_p:], u_spec))
        out = [torch.as_tensor(v, dtype=xu.dtype).reshape(-1) for v in pytree.tree_leaves(po) + pytree.tree_leaves(ur)]
        return torch.cat(out)

    xu = _flat(p_leaves + u_leaves, n)
    jacobian = torch.func.jacfwd(f_flat)
    jac = jacobian(xu) if n is None else torch.func.vmap(jacobian)(xu)
    _, logdet = torch.linalg.slogdet(jac)

    if n is not None:
        params_other = pytree.tree_map(
            lambda v: per_particle(v) if isinstance(v, torch.Tensor) else v, params_other
        )
        u_rev = _per_chain(u_rev)
    new_tr, w, _, _ = Update(fwd.constraint(params_other)).edit(rng, trace, argdiffs)
    # The reverse draw's density, as the weight of a fully constrained
    # `generate` (its assess score): made on the generator's device even
    # where the reverse direction draws nothing (an `assess` of a site-free
    # function sees no tensor to take a device from).
    _, q_rev = rev.aux.generate(rng, u_rev, rev.aux_args(new_tr.get_choices()), n)
    return new_tr, w + q_rev - q_fwd + logdet


def reversible_jump(
    rng: torch.Generator,
    trace: Trace[Any],
    up: JumpProposal,
    down: JumpProposal,
    is_up: Callable[[ChoiceMap], Any],
) -> tuple[Trace[Any], Any]:
    """One reversible-jump MH step between two model configurations, for
    every chain of `trace`. `is_up(choices)` is true (per chain) where the
    `up` proposal applies (e.g. `lambda chm: ~chm["m"]`). Both directions
    run for every chain and the live one is kept. Returns
    `(new_trace, accepted)`; nothing is read on the host."""
    argdiffs = Diff.no_change(trace.get_args())
    up_tr, up_alpha = _directed_jump(rng, trace, up, down, argdiffs)
    down_tr, down_alpha = _directed_jump(rng, trace, down, up, argdiffs)

    going_up = torch.as_tensor(is_up(trace.get_choices()))
    cand = where_tree(going_up, up_tr, down_tr)
    log_alpha = torch.where(going_up, up_alpha, down_alpha)
    u = torch.rand(log_alpha.shape, generator=rng, device=rng.device)
    accept = torch.log(u) < log_alpha
    return where_tree(accept, cand, trace), accept
