"""Faults that the SIR cell can have, each planted under the timed path,
and the number of the judge that each has to fail. `plant(patch)` plants
one, `patch(obj, name, value)` setting an attribute as `setattr` does
(pytest's `monkeypatch.setattr` in the tests). Nothing here runs in the
benchmark's own runs: `control.py --fault` and the tests plant them."""

import math

import torch


def _half_the_particles(patch):
    """The LML and the draw's normalizer from half the weights, the mean
    taken over them (the other half left out)."""
    from genjax_tpu_torch.inference import smc

    lse = smc.logsumexp
    patch(smc, "logsumexp", lambda x: lse(x[: x.shape[0] // 2]) + math.log(2.0))


def _lml_altered(patch):
    """The LML comes out 1e-4 too high."""
    from genjax_tpu_torch.inference.smc import ParticleCollection

    estimate = ParticleCollection.get_log_marginal_likelihood_estimate
    patch(ParticleCollection, "get_log_marginal_likelihood_estimate", lambda self: estimate(self) + 1e-4)


def _draw_unweighted(patch):
    """The particle is drawn uniformly, without its weight."""
    from genjax_tpu_torch.inference.smc import ParticleCollection

    def uniform(self, rng):
        n = self.log_weights.shape[0]
        return self.get_particle(torch.randint(n, (), generator=rng, device=rng.device))

    patch(ParticleCollection, "sample_particle", uniform)


def _draw_argmax(patch):
    """The heaviest particle is taken, without the Gumbel noise."""
    from genjax_tpu_torch.inference.smc import ParticleCollection

    patch(ParticleCollection, "sample_particle", lambda self, rng: self.get_particle(torch.argmax(self.log_weights)))


FAULTS = {
    "half_the_particles": (_half_the_particles, "lml_gap"),
    "lml_altered": (_lml_altered, "lml_gap"),
    "draw_unweighted": (_draw_unweighted, "draw_z"),
    "draw_argmax": (_draw_argmax, "draw_z"),
}
