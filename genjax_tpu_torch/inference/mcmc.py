"""MCMC drivers: the Metropolis-Hastings step and chain runners.

Counterpart of `genjax_tpu/inference/mcmc.py`: `mh`, `mh_chain`,
`gibbs_sweep`, `gibbs_chain`, `enumerative_gibbs`, `share_chain_args` and
`run_chains`.

JAX runs one chain per `vmap` lane. Here a batch of C chains is one trace
whose record (`Trace.batched_leaves`) marks the leaves that carry the
chain axis: each step is one batched edit, one batched draw of C accept
uniforms, and one per-chain select (`core.staging.where_tree`). Nothing in
a step reads a device value on the host, so a chain of S steps queues its
work without waiting for the device.
"""

import dataclasses
from typing import Any, Callable, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMapBuilder
from genjax_tpu_torch.core.concepts import EditRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import Trace, Update
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.core.staging import where_tree
from genjax_tpu_torch.core.typing import per_particle

R = TypeVar("R")


def _log_accept_ratio(rng, trace: Trace[R], proposed: Trace[R], request: EditRequest, w):
    """The MH log accept ratio from an edit's weight. For `HMC` and `MALA`
    the weight is the ratio. For `Regenerate(sel)` the weight is the change
    of the joint score, and the prior-proposal terms at the regenerated
    addresses come off: `w - (project(new, sel) - project(old, sel))`."""
    if isinstance(request, Regenerate):
        sel = request.selection
        return w - (proposed.project(rng, sel) - trace.project(rng, sel))
    return w


def mh(rng: torch.Generator, trace: Trace[R], request: EditRequest) -> tuple[Trace[R], torch.Tensor]:
    """One Metropolis-Hastings step on every chain of `trace`: apply
    `request`, accept or reject each chain with its own uniform, and keep
    the accepted chains' new values. Returns `(new_trace, accepted)`, with
    one flag per chain.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(obs=1.0), (), n=16)
    >>> new, accepted = gx.mh(rng, tr, gx.Regenerate(gx.Selection.at["mu"]))
    >>> accepted.shape, new.get_choices()["obs"] is tr.get_choices()["obs"]
    (torch.Size([16]), True)
    """
    proposed, w, _, _ = request.edit(rng, trace, Diff.no_change(trace.get_args()))
    alpha = _log_accept_ratio(rng, trace, proposed, request, w)
    u = torch.rand(alpha.shape, generator=rng, device=rng.device)
    accept = torch.log(u) < alpha
    return where_tree(accept, proposed, trace), accept


def mh_chain(
    rng: torch.Generator,
    trace: Trace[R],
    request: EditRequest,
    n_steps: int,
    collect: Callable[[Trace[R]], Any] | None = None,
) -> tuple[Trace[R], Any]:
    """`n_steps` MH steps; `collect(trace)` is the statistic recorded after
    each step (the accept flags when None), stacked along a leading step
    axis."""
    out = []
    for _ in range(n_steps):
        trace, accepted = mh(rng, trace, request)
        out.append(accepted if collect is None else collect(trace))
    return trace, pytree.tree_map(lambda *xs: torch.stack(xs), *out)


def gibbs_sweep(rng: torch.Generator, trace: Trace[R], selections) -> Trace[R]:
    """One sweep: an MH step with prior regeneration for each address
    block of `selections`, in order (systematic-scan Metropolis within
    Gibbs)."""
    for sel in selections:
        trace, _ = mh(rng, trace, Regenerate(sel))
    return trace


def gibbs_chain(
    rng: torch.Generator,
    trace: Trace[R],
    selections,
    n_sweeps: int,
    collect: Callable[[Trace[R]], Any] | None = None,
):
    """`n_sweeps` Gibbs sweeps; `collect(trace)` after each, stacked along
    a leading sweep axis (None without `collect`)."""
    selections = tuple(selections)
    out = []
    for _ in range(n_sweeps):
        trace = gibbs_sweep(rng, trace, selections)
        if collect is not None:
            out.append(collect(trace))
    return trace, (pytree.tree_map(lambda *xs: torch.stack(xs), *out) if out else None)


def enumerative_gibbs(rng: torch.Generator, trace: Trace[R], addr, values: torch.Tensor) -> Trace[R]:
    """An exact Gibbs move on a discrete site: each candidate of `values`
    (along axis 0) is scored by an `Update` weight, `w(v) = log p(trace
    with addr=v) - log p(trace)`, so `softmax(w)` is the full conditional;
    one value is drawn per chain and applied. Always accepted. `addr` is a
    string or an address tuple.

    The site must not decide the model's structure: enumerating a `Switch`
    index makes `Update` simulate the newly active branch afresh, so the
    weight is not the index's conditional (use the block `Regenerate` MH
    move there).

    Over a batch of C chains each candidate is one `Update` of all C
    chains (a loop over the candidates, never over the chains), and the
    draw is a Gumbel-argmax on the device.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.gen
    ... def model():
    ...     z = gx.categorical(torch.log(torch.tensor([0.5, 0.5]))) @ "z"
    ...     _ = gx.normal(torch.where(z == 0, -1.0, 1.0), 1.0) @ "y"
    >>> tr, _ = model.importance(torch.Generator().manual_seed(0), gx.ChoiceMap.kw(y=0.9), (), n=8)
    >>> new = gx.enumerative_gibbs(torch.Generator().manual_seed(1), tr, "z", torch.arange(2))
    >>> new.get_choices()["z"].shape, bool(((new.get_choices()["z"] == 0) | (new.get_choices()["z"] == 1)).all())
    (torch.Size([8]), True)
    """
    path = (addr,) if isinstance(addr, str) else tuple(addr)
    argdiffs = Diff.no_change(trace.get_args())
    n = trace.particle_count()
    ws = candidate_weights(rng, trace, path, values)
    gumbel = -torch.log(torch.empty(ws.shape, device=ws.device).exponential_(generator=rng))
    idx = torch.argmax(ws + gumbel, dim=-1)
    chosen = values.to(idx.device).index_select(0, idx.reshape(-1))
    chosen = chosen.reshape(idx.shape + values.shape[1:])
    new, _, _, _ = Update(ChoiceMapBuilder[path].set(chosen if n is None else per_particle(chosen))).edit(
        rng, trace, argdiffs
    )
    return new


def candidate_weights(rng: torch.Generator, trace: Trace[R], path: tuple, values: torch.Tensor) -> torch.Tensor:
    """The `Update` weight of setting `path` to each candidate of `values`
    (along axis 0): `(C, V)` over a batch of C chains, `(V,)` for one."""
    argdiffs = Diff.no_change(trace.get_args())
    n = trace.particle_count()
    ws = []
    for i in range(values.shape[0]):
        _, w, _, _ = Update(ChoiceMapBuilder[path].set(values[i])).edit(rng, trace, argdiffs)
        ws.append(w if n is None else w.expand(n))
    return torch.stack(ws, dim=-1)


def share_chain_args(traces: Trace[R], args: tuple) -> Trace[R]:
    """Give a chain batch one shared copy of the model arguments.

    In JAX a `vmap`-built chain batch holds a broadcast copy of the
    arguments in every chain's trace, and this puts the single copy back.
    The port never broadcasts arguments: a trace made with a particle count
    stores them once, and its record says they are shared. So here it only
    puts the caller's `args` in their place (the same objects, which
    `where_tree` passes through untouched), after checking that record."""
    if any(traces.args_batched):
        raise ValueError("share_chain_args: the trace records per-chain arguments")
    return dataclasses.replace(traces, args=tuple(args))


def run_chains(
    rng: torch.Generator,
    traces: Trace[R],
    request: EditRequest,
    n_steps: int,
    collect: Callable[[Trace[R]], Any] | None = None,
):
    """MH over a batch of chains: `traces` made with a particle count C
    (the chain count, read from the trace's record). Returns the final
    traces and the per-step statistic with the chain axis first: the accept
    flags have shape `(C, n_steps)`, as in JAX; `collect` must return
    values with the chain axis in front.

    The step count is fixed and no step reads the device, so the host
    queues all `n_steps` steps without a synchronisation."""
    if traces.particle_count() is None:
        raise ValueError("run_chains: the trace holds no chain axis (make it with a particle count)")
    final, out = mh_chain(rng, traces, request, n_steps, collect)
    return final, pytree.tree_map(lambda x: x.movedim(0, 1) if x.dim() >= 2 else x, out)


__all__ = [
    "enumerative_gibbs",
    "gibbs_chain",
    "gibbs_sweep",
    "mh",
    "mh_chain",
    "run_chains",
    "share_chain_args",
]
