"""Involutive MCMC: user-programmable deterministic moves with auxiliary
randomness and an automatic Jacobian correction.

Counterpart of `genjax_tpu/inference/involutive.py`: `involutive_step` and
`involutive_mh`. The kernel draws auxiliary randomness `u ~ q(. ; trace)`
(any generative function), maps `(x, u) -> (x', u')` through a
user-supplied involution, and accepts with probability

    min(1, p(x') q(u'; x') / (p(x) q(u; x)) * |det Df(x, u)|).

JAX runs one chain per `vmap` lane. Here a batch of C chains is one trace
with a chain axis: the auxiliary draw is one batched `simulate`, the
involution runs once on the batch (user code on plain tensors, with no
data-dependent control flow), the model term is one batched `Update`
weight and the reverse density one batched `assess`. The Jacobian of one
chain's flat map `(x, u) -> (x', u')` is `torch.func.jacfwd`, batched over
the chains by `torch.func.vmap`, a `(C, d, d)` tensor, then
`torch.linalg.slogdet` (the pattern of `inference/rjmcmc.py`). Nothing is
read on the host.
"""

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.pytree import ravel_pytree
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.core.typing import plain
from genjax_tpu_torch.inference.requests.hmc import grad_tree_unzip

__all__ = ["involutive_mh", "involutive_step"]


def _check_continuous(tree, what: str) -> None:
    _, nongrad = grad_tree_unzip(tree)
    bad = [torch.as_tensor(v).dtype for v in pytree.tree_leaves(nongrad) if v is not None]
    if bad:
        raise TypeError(
            f"involutive_mh: {what} contains non-differentiable leaves (dtypes {bad}); the Jacobian correction "
            "requires continuous values — move discrete updates into a separate Gibbs/MH step."
        )


def involutive_step(
    rng: torch.Generator,
    trace: Trace[Any],
    selection: Selection,
    aux_model: GenerativeFunction[Any],
    involution: Callable[[ChoiceMap, ChoiceMap], tuple[ChoiceMap, ChoiceMap]],
    aux_args: Callable[[ChoiceMap], tuple] = lambda chm: (),
    aux_choices: ChoiceMap | None = None,
):
    """One involutive proposal for every chain of `trace`; returns
    `(proposed_trace, log_alpha)` without accept/reject (compose with your
    own acceptance logic, or use `involutive_mh`).

    `selection` picks the (continuous) model sites the involution acts on;
    `aux_model(*aux_args(choices))` traces the auxiliary randomness (all
    of its sites participate); `involution(x_chm, u_chm)` maps the
    filtered model choice map and the auxiliary choice map to their
    images, and must be a differentiable involution of the pair. It is
    called on the whole batch (values with the chain axis in front) and
    on one chain's values under `torch.func.vmap`, so it must treat the
    leading axes as batch axes. `aux_choices`, where given, are the
    auxiliary draws (with the chain axis): the step then draws nothing and
    is a deterministic function of them.
    """
    n = trace.particle_count()
    argdiffs = Diff.no_change(trace.get_args())
    choices = trace.get_choices()
    x = choices.filter(selection)
    if aux_choices is None:
        aux_tr = aux_model.simulate(rng, aux_args(choices), n)
    else:
        aux_tr, _ = aux_model.generate(rng, aux_choices, aux_args(choices), n)
    u = aux_tr.get_choices()
    _check_continuous(x, "the selected model sites")
    _check_continuous(u, "the auxiliary choices")

    lead = () if n is None else (n,)
    x = pytree.tree_map(plain, x)
    u = pytree.tree_map(plain, u)
    x_flat, un_x = ravel_pytree(x, lead)
    u_flat, un_u = ravel_pytree(u, lead)
    dx = x_flat.shape[-1]

    def f_flat(xu: torch.Tensor) -> torch.Tensor:
        batch = xu.shape[:-1]
        x_new, u_new = involution(un_x(xu[..., :dx]), un_u(xu[..., dx:]))
        return torch.cat([ravel_pytree(x_new, batch)[0], ravel_pytree(u_new, batch)[0]], dim=-1)

    xu = torch.cat([x_flat, u_flat], dim=-1)
    out = f_flat(xu)
    jacobian = torch.func.jacfwd(f_flat)
    jac = jacobian(xu) if n is None else torch.func.vmap(jacobian)(xu)
    _, logdet = torch.linalg.slogdet(jac)

    # The images keep the structure (and the chain-axis record) of x and u.
    x_prime = un_x(out[..., :dx])
    u_prime = un_u(out[..., dx:])

    new_tr, w, _, _ = Update(x_prime).edit(rng, trace, argdiffs)
    # Model term: for a pure value substitution the Update weight IS
    # score(x') - score(x), one density evaluation per step.
    q_fwd = aux_tr.get_score()
    q_rev, _ = aux_model.assess(u_prime, aux_args(new_tr.get_choices()), n)
    return new_tr, w + q_rev - q_fwd + logdet


def involutive_mh(
    rng: torch.Generator,
    trace: Trace[Any],
    selection: Selection,
    aux_model: GenerativeFunction[Any],
    involution: Callable[[ChoiceMap, ChoiceMap], tuple[ChoiceMap, ChoiceMap]],
    aux_args: Callable[[ChoiceMap], tuple] = lambda chm: (),
) -> tuple[Trace[Any], Any]:
    """One involutive MH step on every chain of `trace`: propose via
    `involutive_step`, then accept or reject each chain with its own
    uniform. Returns `(new_trace, accepted)`: dense selects, no host read.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.involutive import involutive_mh
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> @gx.gen
    ... def aux():
    ...     _ = gx.normal(0.0, 0.5) @ "u"
    >>> def reflect(x_chm, u_chm):
    ...     # random walk: (x, u) -> (x + u, -u); self-inverse, det 1
    ...     import torch.utils._pytree as pytree
    ...     x2 = pytree.tree_map(lambda x: x + u_chm["u"], x_chm)
    ...     u2 = pytree.tree_map(lambda u: -u, u_chm)
    ...     return x2, u2
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(y=1.0), (), n=16)
    >>> new_tr, acc = involutive_mh(rng, tr, gx.Selection.at["x"], aux, reflect)
    >>> acc.shape, new_tr.get_choices()["x"].shape
    (torch.Size([16]), torch.Size([16]))
    """
    new_tr, log_alpha = involutive_step(rng, trace, selection, aux_model, involution, aux_args)
    u = torch.rand(log_alpha.shape, generator=rng, device=rng.device)
    accept = torch.log(u) < log_alpha
    return where_tree(accept, new_tr, trace), accept
