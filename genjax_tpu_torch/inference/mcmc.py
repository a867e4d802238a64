"""MCMC drivers: the Metropolis-Hastings step and chain runners.

Counterpart of part of `genjax_tpu/inference/mcmc.py`: `mh`, `mh_chain`,
`share_chain_args` and `run_chains`. The Gibbs drivers come later.

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

from genjax_tpu_torch.core.concepts import EditRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import Trace
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.core.staging import where_tree

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


__all__ = ["mh", "mh_chain", "run_chains", "share_chain_args"]
