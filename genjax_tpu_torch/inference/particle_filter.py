"""Bootstrap particle filter for state-space models built from the GFI.

Counterpart of `genjax_tpu/inference/particle_filter.py::BootstrapFilter`,
with its four resamplers and its `collect=` and `model_args=` hooks. Each
step runs the step model's `generate` once over all K particles (a
leading particle axis, not a loop), then the ESS gate, then resampling
and LML accumulation when the gate fires.

JAX traces the step model once for every step (`lax.scan`); here the
first step runs it with the state marked `per_particle`, and every later
step reuses that trace's particle-axis record (`generate(..., like=)`),
so the body runs on plain tensors.

`filter_stats` counts, over every run in the process, the `steps` after
the first (each with one ESS gate) and the `resamples` the gate fired (the
final equal-weight resample not among them). The run's spans
(`utils/profiling.py`) are `filter.run`, `filter.step`, `filter.gate`,
`filter.gate_read`, `filter.resample` and `filter.take_rows`.
"""

import math
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.gfi import GenerativeFunction
from genjax_tpu_torch.core.pytree import Pytree, tree_map
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.smc import RESAMPLERS
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess
from genjax_tpu_torch.utils.profiling import annotate, span

filter_stats = {"steps": 0, "resamples": 0}


def _take_rows(z, idx: torch.Tensor):
    """The rows `idx` of every leaf of a per-particle state."""
    return tree_map(lambda v: v.index_select(0, idx), z)


@annotate("filter.take_rows")
def _copy_rows(z, idx: torch.Tensor):
    """`_take_rows(z, idx)`, the module's `_take_rows` looked up by name at
    each call."""
    return _take_rows(z, idx)


@annotate("filter.gate")
def _gate_fires(ess: torch.Tensor, bound: float) -> bool:
    """Whether the ESS gate fires, `ess < bound`: the host's read of the
    comparison (`filter.gate_read`) waits for the device."""
    return _read(ess < bound)


_read = annotate("filter.gate_read")(bool)


def _at(tree, t: int):
    """Step `t` of every leaf of a tree with a leading time axis."""
    return tree_map(lambda v: v[t], tree)


@Pytree.dataclass
class BootstrapFilter(Pytree):
    """Particle filter over a generative step model.

    `step_model(z_prev, t, *model_args)` traces the new latent state (its
    return value) and the observation at `obs_addr`;
    `init_model(*model_args)` traces the initial state the same way. The
    state is per particle: every leaf of it carries the particle axis and
    is resampled. `resampling` names one of `smc.RESAMPLERS`.
    """

    step_model: GenerativeFunction[Any]
    init_model: GenerativeFunction[Any]
    n_particles: int = Pytree.static()
    obs_addr: str = Pytree.static(default="y")
    resampling: str = Pytree.static(default="systematic")
    ess_threshold: float = Pytree.static(default=0.5)

    @annotate("filter.run")
    def run(
        self,
        rng: torch.Generator,
        observations: Any,
        model_args: tuple = (),
        collect: Callable[[Any, torch.Tensor], Any] | None = None,
    ):
        """Filter the observation sequence (leaves with a leading time axis,
        on the generator's device); returns `(lml, final_states)` (the
        states equally weighted), or with `collect`, `(lml, final_states,
        collected)`: `collect(z, log_weights)` evaluated at every time index
        after its resampling step, stacked along a leading T axis, the
        value at step 0 first (e.g. the filtering mean
        `lambda z, lw: torch.softmax(lw, 0) @ z`).

        `model_args` are extra arguments appended to both models'
        (`init_model(*model_args)`, `step_model(z_prev, t, *model_args)`):
        the hook for parameter-dependent filters (`inference.pmmh.PMMH`
        re-runs the filter at each proposed parameter).

        Resampling is adaptive: it fires when ESS < ess_threshold * K.
        Weights carry across steps that keep them, and the LML telescopes:
        `logsumexp(lw) - log K` is banked at each resample and the rest is
        settled at the end.

        Each step reduces its weights once (`logsumexp_ess`, one kernel
        launch on the device); the gate, the LML update and the resampler
        share that `logsumexp(lw)`, and the final resample reuses the last.
        The gate is a host branch: one device synchronisation per step.
        """
        n = self.n_particles
        log_n = math.log(n)
        resampler = annotate("filter.resample")(RESAMPLERS[self.resampling])
        model_args = tuple(model_args)

        init_trs, lw = self.init_model.importance(
            rng, ChoiceMap.kw(**{self.obs_addr: _at(observations, 0)}), model_args, n
        )
        z = init_trs.get_retval()
        collected = [] if collect is None else [collect(z, lw)]
        lml = torch.zeros((), device=lw.device)
        lse = None  # logsumexp(lw), once a step has reduced lw
        trs = None  # the last step's trace, whose record the next step reuses
        T = pytree.tree_leaves(observations)[0].shape[0]
        for t in range(1, T):
            with span("filter.step"):
                args = (tree_map(per_particle, z), t, *model_args) if trs is None else (z, t, *model_args)
                trs, ws = self.step_model.generate(
                    rng, ChoiceMap.kw(**{self.obs_addr: _at(observations, t)}), args, n, like=trs
                )
                z = trs.get_retval()
                lw = lw + ws
                lse, ess = logsumexp_ess(lw)
                # The ESS gate is a host branch: reading the comparison waits
                # for the device, one synchronisation per step.
                if _gate_fires(ess, self.ess_threshold * n):
                    filter_stats["resamples"] += 1
                    lml = lml + lse - log_n
                    z = _copy_rows(z, resampler(rng, lw, n, lse))
                    lw = torch.zeros_like(lw)
                    lse = log_n  # logsumexp of n zeros
                if collect is not None:
                    collected.append(collect(z, lw))
            filter_stats["steps"] += 1
        if lse is None:
            lse = logsumexp(lw)
        lml = lml + lse - log_n
        # One final resample so the returned states are equally weighted.
        z_out = _copy_rows(z, resampler(rng, lw, n, lse))
        if collect is None:
            return lml, z_out
        return lml, z_out, pytree.tree_map(lambda *xs: torch.stack(xs), *collected)
