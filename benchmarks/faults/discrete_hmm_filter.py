"""Faults that the discrete-HMM filter cell can have, each planted under the
timed path, and the number of the judge that each has to fail.
`plant(patch)` plants one, `patch(obj, name, value)` setting an attribute
as `setattr` does (pytest's `monkeypatch.setattr` in the tests). Nothing
here runs in the benchmark's own runs: `control.py --fault` and the tests
plant them."""

import math

N_STATES = 64  # the configuration's


def _z_from_observation_row(patch):
    """Each state is drawn from the observation table's row of the value
    observed at its step, in place of the transition table's row of the
    state before. (The two tables are equal in this configuration, so
    reading `obs[z_prev]` for `trans[z_prev]` would be no fault here.)"""
    from genjax_tpu_torch.distributions.library import categorical
    from genjax_tpu_torch.inference.particle_filter import BootstrapFilter
    from genjax_tpu_torch.lang.static import gen
    from genjax_tpu_torch.models import hmm

    def hmm_filter(config, initial_state, n_particles, resampling="systematic", device="cuda"):
        obs = config.observation_log_probs(device)
        seen = {}

        @gen
        def init_model():
            z = categorical(logits=obs[seen["ys"][0]]) @ "z"
            _ = categorical(logits=obs[z]) @ "y"
            return z

        @gen
        def step_model(z_prev, t):
            z = categorical(logits=obs[seen["ys"][t]]) @ "z"
            _ = categorical(logits=obs[z]) @ "y"
            return z

        pf = BootstrapFilter(step_model, init_model, n_particles, obs_addr="y", resampling=resampling)

        class Filter:
            def run(self, rng, observations):
                seen["ys"] = observations
                return pf.run(rng, observations)

        return Filter()

    patch(hmm, "hmm_filter", hmm_filter)


def _argmax_draw(patch):
    """Each categorical draw returns its row's most likely category."""
    import torch

    from genjax_tpu_torch.core.typing import sample_shape
    from genjax_tpu_torch.distributions.library import Categorical

    def sample(self, rng, logits=None, probs=None, n=None):
        if logits is None:
            logits = torch.log(probs)
        return torch.argmax(logits.expand(sample_shape(n, logits)), dim=-1)

    patch(Categorical, "sample", sample)


def _states_shifted(patch):
    """The resampled states come out one state further round the circle."""
    from genjax_tpu_torch.inference import particle_filter

    take = particle_filter._take_rows
    patch(particle_filter, "_take_rows", lambda z, idx: (take(z, idx) + 1) % N_STATES)


def _gate_never(patch):
    """The ESS gate never fires: the ESS it reads is infinite."""
    from genjax_tpu_torch.inference import particle_filter

    reduce = particle_filter.logsumexp_ess

    def altered(lw):
        lse, ess = reduce(lw)
        return lse, ess + math.inf

    patch(particle_filter, "logsumexp_ess", altered)


FAULTS = {
    "z_from_observation_row": (_z_from_observation_row, "lml_z"),
    "argmax_draw": (_argmax_draw, "lml_z"),
    "states_shifted": (_states_shifted, "state_tv"),
    "gate_never": (_gate_never, "resample_gap"),
}
