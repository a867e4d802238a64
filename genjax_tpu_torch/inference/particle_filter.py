"""Bootstrap particle filter for state-space models built from the GFI.

Counterpart of `genjax_tpu/inference/particle_filter.py::BootstrapFilter`
with systematic resampling. Each step runs the step model's `generate`
once over all K particles (a leading particle axis, not a loop), then the
ESS gate, then systematic resampling and LML accumulation when the gate
fires. The JAX `collect=` and `model_args=` hooks come later.

JAX traces the step model once for every step (`lax.scan`); here the
first step runs it with the state marked `per_particle`, and every later
step reuses that trace's particle-axis record (`generate(..., like=)`),
so the body runs on plain tensors.
"""

import math
from typing import Any

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap
from genjax_tpu_torch.core.gfi import GenerativeFunction
from genjax_tpu_torch.core.pytree import Pytree, tree_map
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.smc import systematic_resample
from genjax_tpu_torch.ops import logsumexp, logsumexp_ess


def _take_rows(z, idx: torch.Tensor):
    """The rows `idx` of every leaf of a per-particle state."""
    return tree_map(lambda v: v.index_select(0, idx), z)


@Pytree.dataclass
class BootstrapFilter(Pytree):
    """Particle filter over a generative step model.

    `step_model(z_prev, t)` traces the new latent state (its return value)
    and the observation at `obs_addr`; `init_model()` traces the initial
    state the same way. The state is per particle: every leaf of it
    carries the particle axis and is resampled.
    """

    step_model: GenerativeFunction[Any]
    init_model: GenerativeFunction[Any]
    n_particles: int = Pytree.static()
    obs_addr: str = Pytree.static(default="y")
    ess_threshold: float = Pytree.static(default=0.5)

    def run(self, rng: torch.Generator, observations: torch.Tensor) -> tuple[torch.Tensor, Any]:
        """Filter the observation sequence (leading time axis, on the
        generator's device); returns (log marginal likelihood estimate,
        final particle states, equally weighted).

        Resampling is adaptive: it fires when ESS < ess_threshold * K.
        Weights carry across steps that keep them, and the LML telescopes:
        `logsumexp(lw) - log K` is banked at each resample and the rest is
        settled at the end.

        Each step reduces its weights once (`logsumexp_ess`, one kernel
        launch on the device); the gate, the LML update and the resampler
        share that `logsumexp(lw)`, and the final resample reuses the last.
        """
        n = self.n_particles
        log_n = math.log(n)

        init_trs, lw = self.init_model.importance(
            rng, ChoiceMap.kw(**{self.obs_addr: observations[0]}), (), n
        )
        z = init_trs.get_retval()
        lml = torch.zeros((), device=lw.device)
        lse = None  # logsumexp(lw), once a step has reduced lw
        trs = None  # the last step's trace, whose record the next step reuses
        for t in range(1, observations.shape[0]):
            args = (tree_map(per_particle, z), t) if trs is None else (z, t)
            trs, ws = self.step_model.generate(
                rng, ChoiceMap.kw(**{self.obs_addr: observations[t]}), args, n, like=trs
            )
            z = trs.get_retval()
            lw = lw + ws
            lse, ess = logsumexp_ess(lw)
            # The ESS gate is a host branch: reading the comparison waits
            # for the device, one synchronisation per step.
            if ess < self.ess_threshold * n:
                lml = lml + lse - log_n
                z = _take_rows(z, systematic_resample(rng, lw, n, lse))
                lw = torch.zeros_like(lw)
                lse = log_n  # logsumexp of n zeros
        if lse is None:
            lse = logsumexp(lw)
        lml = lml + lse - log_n
        # One final resample so the returned states are equally weighted.
        z_out = _take_rows(z, systematic_resample(rng, lw, n, lse))
        return lml, z_out
