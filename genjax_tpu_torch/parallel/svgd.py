"""Sharded SVGD: Stein particle transport with the particle axis spanning
the ranks of a mesh axis.

Counterpart of `genjax_tpu/parallel/svgd.py`. SVGD's interaction term is
an N x N kernel against all particles, so each rank computes its
`(N/n, N)` block of it from two all-gathers per step (positions and
gradients, each `(N, D)` floats), followed by the dense port's
`inference/svgd.py::stein_phi_block` on its own rows: the same `h` gives
the same transport as the dense driver. Gradients need no communication
(each rank differentiates its own particles).

The median heuristic takes this rank's block against the first
`_MEDIAN_SAMPLE` particles (`_bandwidth_from_d2_block`) and averages the
ranks' bandwidths with one sum all-reduce, so every rank uses the same h;
pass `bandwidth` for the dense driver's transport. The per-step
diagnostic, the mean |phi|, is summed locally and all-reduced once at the
end, so a step with an explicit bandwidth runs exactly the two
all-gathers.
"""

from typing import Any

import torch

from genjax_tpu_torch.adev.core import fork
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.typing import on_device
from genjax_tpu_torch.inference.svgd import (
    _MEDIAN_SAMPLE,
    _bandwidth_from_d2_block,
    _grad_batch,
    _prepare_particles,
    _rebuild_particles,
    stein_phi_block,
)
from genjax_tpu_torch.parallel import collectives as C
from genjax_tpu_torch.parallel.mesh import Mesh

__all__ = ["sharded_stein_direction", "sharded_svgd"]


def sharded_stein_direction(
    x_local: torch.Tensor,
    g_local: torch.Tensor,
    mesh: Mesh,
    axis: str,
    n_total: int,
    bandwidth: float | None = None,
    kernel_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """This rank's rows of the Stein direction phi, from its `(n_local, D)`
    positions and gradients: two all-gathers along `axis`, then
    `stein_phi_block` of the rank's rows against all `n_total`."""
    x_all = C.all_gather(x_local, mesh, axis)
    g_all = C.all_gather(g_local, mesh, axis)
    if bandwidth is None:
        m = min(x_all.shape[0], _MEDIAN_SAMPLE)
        xm = x_all[:m]
        d2m = torch.clamp(
            (x_local * x_local).sum(-1)[:, None] + (xm * xm).sum(-1)[None, :] - 2.0 * (x_local @ xm.T), min=0.0
        )
        h = C.all_reduce(_bandwidth_from_d2_block(d2m, n_total, None), mesh, axis, "sum") / mesh.shape[axis]
    else:
        h = on_device(bandwidth, x_local.device, x_local.dtype)
    return stein_phi_block(x_local, x_all, g_all, h, n_total, kernel_dtype)


def sharded_svgd(
    rng: torch.Generator,
    model: GenerativeFunction[Any],
    args: tuple,
    observations: ChoiceMap,
    selection: Selection,
    n_particles: int,
    n_steps: int,
    mesh: Mesh,
    axis: str = "particles",
    step_size: float = 0.1,
    bandwidth: float | None = None,
) -> tuple[Trace[Any], torch.Tensor]:
    """`inference.svgd.svgd` with the particle axis over `mesh[axis]`:
    each rank initializes its `n_particles / n` particles on its stream
    (`fork(rng, n)[rank]`), transports them, and writes them back with one
    `Update`. Returns `(this rank's traces, mean |phi| per step over all
    particles)`; `n_particles` must divide by the axis size."""
    n_dev = mesh.shape[axis]
    if n_particles % n_dev != 0:
        raise ValueError(
            f"sharded_svgd: n_particles={n_particles} must be divisible by the '{axis}' mesh axis size {n_dev}."
        )
    stream = fork(rng, n_dev)[mesh.rank(axis)]
    traces, x, unravel = _prepare_particles(stream, model, args, observations, selection, n_particles // n_dev)
    grad_fn = _grad_batch(selection, traces, args, unravel)
    phi_sums = []
    for _ in range(n_steps):
        phi = sharded_stein_direction(x, grad_fn(x), mesh, axis, n_particles, bandwidth)
        x = x + step_size * phi
        phi_sums.append(torch.abs(phi).sum())
    phi_norms = torch.stack(phi_sums) if phi_sums else x.new_zeros(0)
    phi_norms = C.all_reduce(phi_norms, mesh, axis, "sum") / (n_particles * x.shape[-1])
    return _rebuild_particles(stream, traces, x, unravel, args), phi_norms
