"""Sharded parallel tempering: the replica ladder spans the ranks of a
mesh axis.

Counterpart of `genjax_tpu/parallel/pt.py`. Each rank holds `T / n`
replicas and moves them with the dense tempered-MH step
(`inference/tempered.py::tempered_mh`, one batched step over its block)
on its own stream, `fork(rng, n)[rank]`.

Replica STATE never crosses ranks: the exchange moves only the
rung -> replica permutation, which every rank computes alike
(`inference/parallel_tempering.py::deo_exchange`) from the all-gathered
log-likelihoods and swap uniforms drawn from the replicated generator.
The one collective per sweep is the all-gather of the (T,) log
likelihoods, plus that of the collected statistic when `collect` is
given: O(T) floats per sweep, however large a replica's trace.
"""

import dataclasses
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.typing import per_particle, plain
from genjax_tpu_torch.inference.parallel_tempering import ParallelTempering, PTResult, deo_exchange, tempered_mh
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.parallel import collectives as C
from genjax_tpu_torch.parallel.mesh import Mesh


def local_replicas(pt: ParallelTempering, n_ranks: int, rank: int) -> tuple[int, int]:
    """(first replica, replica count) of `rank`'s block of the ladder."""
    n = pt.betas.shape[0]
    if n % n_ranks != 0:
        raise ValueError(f"replica count {n} must divide evenly over the {n_ranks} ranks of the mesh axis.")
    return rank * (n // n_ranks), n // n_ranks


def move_block(stream: torch.Generator, pt: ParallelTempering, traces, logliks, beta_by_replica, lo: int, obs_sel):
    """One sweep's moves of the replicas `[lo, lo + len(logliks))`, each at
    its inverse temperature in `beta_by_replica`: `pt.n_moves` batched
    tempered-MH steps on `stream`. Returns `(traces, logliks)`."""
    local_beta = per_particle(beta_by_replica[lo : lo + logliks.shape[0]])
    request = pt._request_for(local_beta)
    beta = plain(local_beta)
    for _ in range(pt.n_moves):
        traces, logliks, _ = tempered_mh(stream, traces, request, beta, obs_sel, logliks)
    return traces, logliks


def sharded_pt_run(
    rng: torch.Generator,
    pt: ParallelTempering,
    target: Target,
    n_sweeps: int,
    mesh: Mesh,
    axis: str = "replicas",
    collect: Callable[[Any], Any] | None = None,
    init_constraint=None,
) -> PTResult:
    """Run `pt` with its replica axis over `mesh[axis]`. Each rank
    initializes and moves its own replicas; `perm`, `collected` (from the
    replica holding `betas[0]`) and `swap_rates` are the same on every
    rank, `traces` and `logliks` are this rank's replicas'."""
    n = pt.betas.shape[0]
    lo, t_l = local_replicas(pt, mesh.shape[axis], mesh.rank(axis))
    obs_sel = target.constraint.get_selection()
    stream = fork(rng, mesh.shape[axis])[mesh.rank(axis)]
    traces, logliks = dataclasses.replace(pt, betas=pt.betas[lo : lo + t_l]).init(stream, target, init_constraint)
    betas = torch.as_tensor(pt.betas, dtype=logliks.dtype).to(logliks.device)
    perm = torch.arange(n, device=logliks.device)
    collected, accs, attempts = [], [], []
    for sweep in range(n_sweeps):
        beta_by_replica = torch.zeros_like(betas).scatter(0, perm, betas)
        traces, logliks = move_block(stream, pt, traces, logliks, beta_by_replica, lo, obs_sel)
        ll_all = C.all_gather(logliks, mesh, axis)
        log_u = torch.log(torch.rand(n, generator=rng, device=rng.device))
        perm, acc, is_left = deo_exchange(perm, ll_all, betas, sweep % 2, log_u)
        if collect is not None:
            cold = perm[:1]
            gathered = pytree.tree_map(lambda v: C.all_gather(v, mesh, axis), collect(traces))
            collected.append(pytree.tree_map(lambda v: v.index_select(0, cold).squeeze(0), gathered))
        accs.append(acc[:-1])
        attempts.append(is_left[:-1])
    n_att = torch.clamp(torch.stack(attempts).sum(0), min=1)
    swap_rates = torch.stack(accs).sum(0) / n_att
    out = pytree.tree_map(lambda *xs: torch.stack(xs), *collected) if collected else None
    return PTResult(traces, logliks, perm, out, swap_rates)


__all__ = ["sharded_pt_run"]
