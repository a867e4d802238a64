"""The particle path as a whole, port (`genjax_tpu_torch`) against JAX
(`genjax_tpu`) on the CPU: beta-bernoulli SIR, the SSM bootstrap filter,
and state carried from one package to the other by `convert.py`.

The two packages draw different random numbers, so SIR and the filter
are compared statistically: each estimate at 5 standard errors of the
exact value, or the two packages' means at 5 combined standard errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference.smc import ImportanceK as JaxImportanceK
from genjax_tpu.inference.sp import Target as JaxTarget
from genjax_tpu.models.beta_bernoulli import beta_bernoulli as jax_beta_bernoulli
from genjax_tpu.models.beta_bernoulli import run_sir as jax_run_sir
from genjax_tpu.models.ssm import run_bootstrap_filter as jax_run_filter
from genjax_tpu.models.ssm import simulate_ssm_data as jax_simulate_ssm_data
from genjax_tpu_torch import convert
from genjax_tpu_torch.entry import entry
from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli, run_sir
from genjax_tpu_torch.models.ssm import run_bootstrap_filter

torch.set_num_threads(1)

K = 4096
TRIALS = 64
EXACT_LML = math.log(0.5)  # p(v = True) under Beta(2, 2)
POSTERIOR_MEAN = 0.6  # Beta(3, 2)
POSTERIOR_SD = math.sqrt(3 * 2 / (5**2 * 6))


def _within(values: np.ndarray, exact: float, n_se: float = 5.0) -> None:
    se = values.std(ddof=1) / math.sqrt(values.size)
    assert abs(values.mean() - exact) < n_se * se, (values.mean(), exact, se)


def _jax_sir_trials():
    target = JaxTarget(jax_beta_bernoulli, (2.0, 2.0), jgx.ChoiceMap.d({"v": True}))
    alg = JaxImportanceK(target, k_particles=K)

    def one(key):
        col = alg.run_smc(key)
        w = jax.nn.softmax(col.get_log_weights())
        return col.get_log_marginal_likelihood_estimate(), jnp.sum(w * col.get_particles().get_choices()["p"])

    lml, mean = jax.jit(jax.vmap(one))(jax.random.split(jax.random.key(0), TRIALS))
    return np.asarray(lml, np.float64), np.asarray(mean, np.float64)


def _torch_sir_trials():
    target = tgx.Target(beta_bernoulli, (2.0, 2.0), tgx.ChoiceMap.d({"v": True}))
    alg = tgx.ImportanceK(target, k_particles=K)
    rng = torch.Generator().manual_seed(0)
    lml, mean = [], []
    for _ in range(TRIALS):
        col = alg.run_smc(rng)
        w = torch.softmax(col.get_log_weights(), 0)
        lml.append(float(col.get_log_marginal_likelihood_estimate()))
        mean.append(float((w * col.get_particles().get_choices()["p"]).sum()))
    return np.array(lml), np.array(mean)


def test_sir_lml_and_posterior_mean_in_both_packages():
    for lml, mean in (_torch_sir_trials(), _jax_sir_trials()):
        _within(lml, EXACT_LML)
        _within(mean, POSTERIOR_MEAN)


def test_sir_resampled_particle_mean_in_both_packages():
    # One resampled particle per trial (`random_weighted`): its p has the
    # posterior's standard deviation, so the mean over trials has SE
    # POSTERIOR_SD / sqrt(TRIALS).
    se = POSTERIOR_SD / math.sqrt(TRIALS)
    got = float(run_sir(torch.Generator().manual_seed(1), True, K, TRIALS))
    ref = float(jax_run_sir(jax.random.key(1), True, K, TRIALS))
    assert abs(got - POSTERIOR_MEAN) < 5 * se
    assert abs(ref - POSTERIOR_MEAN) < 5 * se


def test_bootstrap_filter_agrees_with_jax_on_the_same_observations():
    _, ys = jax_simulate_ssm_data(jax.random.key(1), 20)
    ys_t = convert.tensor(np.asarray(ys), "cpu")
    seeds = 16
    ref = np.asarray(
        jax.jit(jax.vmap(lambda k: jax_run_filter(k, ys, n_particles=K)[0]))(
            jax.random.split(jax.random.key(2), seeds)
        ),
        np.float64,
    )
    got = np.array(
        [float(run_bootstrap_filter(torch.Generator().manual_seed(s), ys_t, n_particles=K)[0]) for s in range(seeds)]
    )
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    se = math.sqrt(got.var(ddof=1) / seeds + ref.var(ddof=1) / seeds)
    assert abs(got.mean() - ref.mean()) < 5 * se, (got.mean(), ref.mean(), se)


def test_particle_collection_carried_from_jax_keeps_its_lml_and_scores():
    target = JaxTarget(jax_beta_bernoulli, (2.0, 2.0), jgx.ChoiceMap.d({"v": True}))
    jcol = JaxImportanceK(target, k_particles=K).run_smc(jax.random.key(3))
    choices = jcol.get_particles().get_choices()
    col = convert.particle_collection(
        beta_bernoulli,
        (2.0, 2.0),
        {"p": np.asarray(choices["p"])},
        np.asarray(jcol.get_log_weights()),
        device="cpu",
        observations={"v": np.asarray(choices["v"])},
    )
    ref_lml = float(jcol.get_log_marginal_likelihood_estimate())
    assert abs(float(col.get_log_marginal_likelihood_estimate()) - ref_lml) <= 1e-5
    np.testing.assert_allclose(
        col.get_particles().get_score().numpy(), np.asarray(jcol.get_particles().get_score()), atol=1e-5
    )
    assert col.get_particles().get_choices()["v"].shape == ()  # the observation, shared


def test_convert_refuses_a_trace_with_a_missing_address():
    with pytest.raises(tgx.MissingAddress):
        convert.static_trace(beta_bernoulli, (2.0, 2.0), {"p": np.float32(0.3)}, device="cpu")


def test_entry_runs_on_the_card_unless_asked_for_the_cpu():
    # The default device is CUDA: without a card entry() refuses rather
    # than running on the CPU.
    if torch.cuda.is_available():
        assert entry()[1][0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    fn, (rng,) = entry("cpu")
    lml, z_mean = fn(rng)
    assert lml.device.type == "cpu" and np.isfinite(float(lml)) and np.isfinite(float(z_mean))


def test_convert_puts_state_on_the_card_by_default():
    x = np.zeros(3, np.float32)
    if torch.cuda.is_available():
        assert convert.tensor(x).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):  # a CPU-only torch asserts
            convert.tensor(x)
    assert convert.tensor(x, "cpu").device.type == "cpu"
