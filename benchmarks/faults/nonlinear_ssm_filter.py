"""Faults that the filter cell can have, each planted under the timed path,
and the number of the judge that each has to fail. `plant(patch)` plants
one, `patch(obj, name, value)` setting an attribute as `setattr` does
(pytest's `monkeypatch.setattr` in the tests). Nothing here runs in the
benchmark's own runs: `control.py --fault` and the tests plant them."""

import math

import torch


def _step_unchanged(patch):
    """Each filter step returns the state it was given."""
    from genjax_tpu_torch.distributions.library import normal
    from genjax_tpu_torch.lang.static import gen
    from genjax_tpu_torch.models import ssm

    make = ssm.make_ssm_models

    def models(trans_coef, trans_noise, obs_noise):
        init_model, _ = make(trans_coef, trans_noise, obs_noise)

        @gen
        def step_model(z_prev, _t):
            _ = normal(z_prev, obs_noise) @ "y"
            return z_prev

        return init_model, step_model

    patch(ssm, "make_ssm_models", models)


def _half_the_batch(patch):
    """Each resample copies only the first half of its ancestors, twice."""
    from genjax_tpu_torch.inference import particle_filter

    take = particle_filter._take_rows

    def half(z, idx):
        h = idx[: idx.shape[0] // 2]
        return take(z, torch.cat([h, h]))

    patch(particle_filter, "_take_rows", half)


def _states_altered(patch):
    """The resampled states come out shifted by 0.1."""
    from genjax_tpu_torch.inference import particle_filter

    take = particle_filter._take_rows
    patch(particle_filter, "_take_rows", lambda z, idx: take(z, idx) + 0.1)


def _gate(ess_of):
    """A fault of the ESS gate: the ESS it reads is `ess_of(ess)`."""

    def plant(patch):
        from genjax_tpu_torch.inference import particle_filter

        reduce = particle_filter.logsumexp_ess

        def altered(lw):
            lse, ess = reduce(lw)
            return lse, ess_of(ess)

        patch(particle_filter, "logsumexp_ess", altered)

    return plant


FAULTS = {
    "step_unchanged": (_step_unchanged, "lml_z"),
    "half_the_batch": (_half_the_batch, "distinct_gap"),
    "states_altered": (_states_altered, "state_chi2"),
    "gate_always": (_gate(lambda ess: ess * 0.0), "resample_gap"),
    "gate_never": (_gate(lambda ess: ess + math.inf), "resample_gap"),
}
