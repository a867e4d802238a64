"""The conjugate normal model and the dense SMC round at a million
particles.

Counterpart of `bench.py::_smc_1m`, the round the JAX bench takes its "ESS
per wallclock sec" from: `x ~ N(0, 1)`, `y ~ N(x, 1)` with `y` observed;
one round is `SMCDriver.init`, the LML, the importance ESS,
`maybe_resample` (its threshold over 1, so it always fires), a
`Regenerate` rejuvenation of `x`, and the mean of `x`.
"""

import dataclasses
import math

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.requests import Regenerate
from genjax_tpu_torch.distributions.library import normal
from genjax_tpu_torch.inference.smc import SMCDriver
from genjax_tpu_torch.inference.sp import Target
from genjax_tpu_torch.lang.static import gen


@gen
def conjugate():
    x = normal(0.0, 1.0) @ "x"
    return normal(x, 1.0) @ "y"


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """The round of `bench.py:477-531`: K = 1M, `y = 1`, 20 rounds."""

    n_particles: int = 1_000_000
    y: float = 1.0
    rounds: int = 20
    ess_threshold: float = 2.0

    def target(self) -> Target:
        return Target(conjugate, (), ChoiceMap.kw(y=self.y))

    def driver(self) -> SMCDriver:
        return SMCDriver(n_particles=self.n_particles, ess_threshold=self.ess_threshold)

    def exact_lml(self) -> float:
        """log N(y; 0, sqrt 2)."""
        return -0.25 * self.y**2 - 0.5 * math.log(2 * math.pi * 2.0)

    def posterior_mean(self) -> float:
        return 0.5 * self.y


def smc_round(rng: torch.Generator, driver: SMCDriver, target: Target):
    """One round: `(lml, importance ESS, mean of x after rejuvenation,
    the resampled collection)`."""
    col = driver.init(rng, target)
    lml = col.get_log_marginal_likelihood_estimate()
    ess0 = col.get_ess()
    resampled = driver.maybe_resample(rng, col)
    moved = driver.rejuvenate(rng, resampled, Regenerate(Selection.at["x"]))
    return lml, ess0, moved.get_particles().get_choices()["x"].mean(), resampled
