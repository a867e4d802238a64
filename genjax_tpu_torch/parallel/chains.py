"""Sharded MCMC chains: the chain axis spans the ranks of a mesh axis.

Counterpart of `genjax_tpu/parallel/chains.py`. Chains are independent,
so no collective runs: each rank moves its own chains with the dense
driver (`inference/mcmc.py::run_chains`, one batched edit per step over
its block) on its own stream, `fork(rng, n)[rank]` of the replicated
generator, and keeps what it collects.
"""

from typing import Any, Callable, TypeVar

import torch

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.concepts import EditRequest
from genjax_tpu_torch.core.gfi import Trace
from genjax_tpu_torch.inference.mcmc import run_chains
from genjax_tpu_torch.parallel.mesh import Mesh

R = TypeVar("R")


def sharded_mh_chains(
    rng: torch.Generator,
    traces: Trace[R],
    request: EditRequest,
    n_steps: int,
    mesh: Mesh,
    axis: str = "chains",
    collect: Callable[[Trace[R]], Any] | None = None,
):
    """Run MH on this rank's chains (`traces`, made with a chain count;
    shared leaves such as `share_chain_args`'s model arguments are whole on
    every rank). Returns `(final_traces, collected)`, both rank-local, the
    statistic with the chain axis first (the accept flags `(C / n,
    n_steps)`), as JAX's `out_specs` keep the chain axis sharded."""
    stream = fork(rng, mesh.shape[axis])[mesh.rank(axis)]
    return run_chains(stream, traces, request, n_steps, collect)


__all__ = ["sharded_mh_chains"]
