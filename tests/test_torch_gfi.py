"""The port's `@gen` language and GFI (`genjax_tpu_torch`) against
`genjax_tpu`: fully constrained `importance` and `assess` of the two
particle-path models, on K = 4096 numpy-made choices, against `jax.vmap`
of the JAX methods.

Weights and scores agree to atol = 1e-5: the same float32 densities,
summed over two or three sites, with the libraries' `log` differing by
an ulp. Out-of-support choices score exactly `-inf` on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.models.beta_bernoulli import beta_bernoulli as jax_beta_bernoulli
from genjax_tpu.models.ssm import make_ssm_models as jax_make_ssm_models
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli
from genjax_tpu_torch.models.ssm import make_ssm_models

torch.set_num_threads(1)

K = 4096


def _beta_bernoulli_choices():
    rng = np.random.default_rng(0)
    p = rng.uniform(0.0, 1.0, K).astype(np.float32)
    p[:4] = [-0.1, 1.1, 0.0, 1.0]  # out of support / boundary
    v = rng.random(K) < 0.6
    return {"p": p, "v": v}, (2.0, 2.0), jax_beta_bernoulli, beta_bernoulli


def _ssm_step_choices():
    rng = np.random.default_rng(1)
    z_prev = rng.standard_normal(K).astype(np.float32)
    z = rng.standard_normal(K).astype(np.float32)
    y = (z + 0.4 * rng.standard_normal(K)).astype(np.float32)
    return {"z": z, "y": y}, (z_prev, 3), jax_make_ssm_models()[1], make_ssm_models()[1]


MODELS = {"beta_bernoulli": _beta_bernoulli_choices, "ssm_step": _ssm_step_choices}


def _jax_batched(method, jax_model, choices, args):
    batched_args = tuple(a for a in args if isinstance(a, np.ndarray))
    other = tuple(a for a in args if not isinstance(a, np.ndarray))

    def one(key, chm_vals, *bargs):
        chm = jgx.ChoiceMap.d(chm_vals)
        full_args = (*bargs, *other)
        if method == "assess":
            return jax_model.assess(chm, full_args)[0]
        tr, w = jax_model.importance(key, chm, full_args)
        return tr.get_score(), w

    keys = jax.random.split(jax.random.key(0), K)
    vals = {k: jnp.asarray(v) for k, v in choices.items()}
    return jax.vmap(one)(keys, vals, *[jnp.asarray(a) for a in batched_args])


def _torch_args(args):
    # The numpy arguments are the per-particle ones (JAX vmaps them).
    return tuple(per_particle(torch.from_numpy(a)) if isinstance(a, np.ndarray) else a for a in args)


def _per_particle_choices(choices):
    return tgx.ChoiceMap.d({k: per_particle(torch.from_numpy(v)) for k, v in choices.items()})


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape == (K,)
    np.testing.assert_array_equal(got == -np.inf, ref == -np.inf)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fully_constrained_importance_matches_vmapped_jax(model):
    choices, args, jax_model, torch_model = MODELS[model]()
    ref_score, ref_w = _jax_batched("importance", jax_model, choices, args)
    chm = _per_particle_choices(choices)
    tr, w = torch_model.importance(torch.Generator().manual_seed(0), chm, _torch_args(args), n=K)
    _close(w.numpy(), ref_w)
    _close(tr.get_score().numpy(), ref_score)
    # The constrained values are the trace's choices, untouched.
    for addr, v in choices.items():
        np.testing.assert_array_equal(tr.get_choices()[addr].numpy(), v)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_assess_matches_vmapped_jax(model):
    choices, args, jax_model, torch_model = MODELS[model]()
    ref = _jax_batched("assess", jax_model, choices, args)
    score, _ = torch_model.assess(_per_particle_choices(choices), _torch_args(args))
    _close(score.numpy(), ref)


def test_batched_importance_samples_latents_and_weights_by_the_observation():
    # Only the observation constrained: z is drawn per particle, y is
    # stored once, and the weight is log N(y; z, 0.4) particle by particle.
    _, step = make_ssm_models()
    z_prev = torch.from_numpy(np.random.default_rng(2).standard_normal(K).astype(np.float32))
    tr, w = step.importance(torch.Generator().manual_seed(5), tgx.ChoiceMap.kw(y=0.7), (per_particle(z_prev), 1), n=K)
    z = tr.get_choices()["z"]
    assert z.shape == (K,) and tr.get_choices()["y"].shape == ()
    torch.testing.assert_close(w, tgx.normal.logpdf(torch.tensor(0.7), z, 0.4))
    score, _ = step.assess(tr.get_choices(), (z_prev, 1))
    torch.testing.assert_close(score, tr.get_score())


def test_literal_sites_batch_to_the_particle_count():
    tr = beta_bernoulli.simulate(torch.Generator().manual_seed(0), (2.0, 2.0), n=16)
    assert tr.get_choices()["p"].shape == (16,) and tr.get_choices()["v"].dtype == torch.bool
    assert tr.get_score().shape == (16,)
    single = beta_bernoulli.simulate(torch.Generator().manual_seed(0), (2.0, 2.0))
    assert single.get_choices()["p"].shape == ()


def test_address_reuse_and_missing_address_are_raised_like_jax():
    @tgx.gen
    def reuse():
        x = tgx.normal(0.0, 1.0) @ "x"
        return tgx.normal(x, 1.0) @ "x"

    @jgx.gen
    def jax_reuse():
        x = jgx.normal(0.0, 1.0) @ "x"
        return jgx.normal(x, 1.0) @ "x"

    rng = torch.Generator().manual_seed(0)
    with pytest.raises(tgx.AddressReuse):
        reuse.simulate(rng, ())
    with pytest.raises(tgx.AddressReuse):
        reuse.importance(rng, tgx.ChoiceMap.empty(), (), n=4)
    with pytest.raises(jgx.AddressReuse):
        jax_reuse.simulate(jax.random.key(0), ())

    with pytest.raises(tgx.MissingAddress):
        beta_bernoulli.assess(tgx.ChoiceMap.d({"p": 0.3}), (2.0, 2.0))
    with pytest.raises(jgx.MissingAddress):
        jax_beta_bernoulli.assess(jgx.ChoiceMap.d({"p": 0.3}), (2.0, 2.0))


def test_target_filters_out_observations_like_jax():
    target = tgx.Target(beta_bernoulli, (2.0, 2.0), tgx.ChoiceMap.d({"v": True}))
    tr, _ = target.importance(torch.Generator().manual_seed(0), tgx.ChoiceMap.empty(), n=8)
    latents = target.filter_to_unconstrained(tr.get_choices())
    assert "p" in latents and "v" not in latents
    assert bool(tr.get_choices()["v"])
    left_wins = tgx.ChoiceMap.kw(x=1.0) | tgx.ChoiceMap.kw(x=2.0, y=3.0)
    assert (left_wins["x"], left_wins["y"]) == (1.0, 3.0)
    sel = tgx.Selection.at["x"]
    assert ("x" in sel, "y" in sel, "y" in ~sel) == (True, False, True)
