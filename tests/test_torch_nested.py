"""The port's nested sampler (`genjax_tpu_torch.inference.nested`) against
`genjax_tpu.inference.nested` on the CPU.

Deterministic: the evidence from given dead and live log-likelihoods (the
shrinkage weights and the live remainder) equals the JAX formula on the
same numpy inputs to 1e-5 relative. Random: at a size the CPU runs in
seconds (1-D conjugate model, 100 live points, 500 retirements), each
run's evidence is within 0.3 nats of the closed form, the tolerance of
JAX's own test (`tests/inference/test_nested.py`), as JAX's run at the
same size is; the dead points' posterior mean is the conjugate one.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference.nested import NestedSampler as JNestedSampler
from genjax_tpu_torch.inference.nested import NestedSampler, evidence

torch.set_num_threads(1)

Y = 1.0
# x ~ N(0, 1), y ~ N(x, 0.5): y ~ N(0, sqrt(1.25)); x | y ~ N(0.8 y, sqrt(0.2)).
EXACT = -0.5 * Y**2 / 1.25 - 0.5 * math.log(2 * math.pi * 1.25)
SIZE = dict(n_live=100, n_iters=500, n_mcmc=8, step_scale=0.5)


@tgx.gen
def tmodel():
    x = tgx.normal(0.0, 1.0) @ "x"
    _ = tgx.normal(x, 0.5) @ "y"


@jgx.gen
def jmodel():
    x = jgx.normal(0.0, 1.0) @ "x"
    _ = jgx.normal(x, 0.5) @ "y"


def _jax_evidence(dead_ll, live_ll, n):
    # The closing lines of `genjax_tpu/inference/nested.py::NestedSampler.run`.
    i = jnp.arange(1, dead_ll.shape[0] + 1, dtype=jnp.float32)
    log_x = -i / float(n)
    log_prev = jnp.concatenate([jnp.zeros(1), log_x[:-1]])
    log_w = log_prev + jnp.log1p(-jnp.exp(-1.0 / float(n)))
    log_dead = dead_ll + log_w
    log_live = live_ll + log_x[-1] - jnp.log(float(n))
    return logsumexp(jnp.concatenate([log_dead, log_live])), log_dead, logsumexp(log_live)


@pytest.mark.parametrize("n_live,n_iters", [(10, 40), (100, 500), (400, 2400)])
def test_evidence_from_given_logliks_like_jax(n_live, n_iters):
    rng = np.random.default_rng(n_live)
    dead = np.sort(rng.normal(-3.0, 2.0, n_iters)).astype(np.float32)
    live = (dead[-1] + np.abs(rng.normal(0.0, 0.5, n_live))).astype(np.float32)
    got = evidence(torch.from_numpy(dead), torch.from_numpy(live), n_live)
    ref = _jax_evidence(jnp.asarray(dead), jnp.asarray(live), n_live)
    for g, r in zip(got, ref):
        g, r = g.numpy().astype(np.float64), np.asarray(r, dtype=np.float64)
        assert np.all(np.abs(g - r) <= 1e-5 * np.maximum(1.0, np.abs(r))), (g, r)


@pytest.mark.parametrize("seed", [0, 1])
def test_evidence_and_posterior_within_jax_tolerance(seed):
    ns = NestedSampler(tmodel, (), tgx.ChoiceMap.kw(y=Y), tgx.Selection.at["x"], **SIZE)
    out = ns.run(torch.Generator().manual_seed(seed))
    assert abs(float(out["lml"]) - EXACT) < 0.3
    assert 0.15 < float(out["accept_rate"]) < 0.9
    assert float(out["remainder_frac"]) < 0.5
    w = torch.softmax(out["log_post_weights"].double(), 0)
    xs = out["dead_choices"]["x"].double()
    assert xs.shape == (SIZE["n_iters"],) and out["dead_logliks"].shape == (SIZE["n_iters"],)
    # Posterior mean 0.8 y and sd sqrt(0.2): the weighted dead points'
    # mean within 0.12 (the JAX test's tolerance on its posterior mean).
    assert abs(float(w @ xs) - 0.8 * Y) < 0.12
    # The retired likelihoods rise: each replacement beats the one it replaced.
    assert bool((out["dead_logliks"][1:] >= out["dead_logliks"][:-1] - 1e-6).all())


def test_jax_at_the_same_size_is_within_the_same_tolerance():
    ns = JNestedSampler(jmodel, (), jgx.ChoiceMap.kw(y=Y), jgx.Selection.at["x"], **SIZE)
    out = jax.jit(ns.run)(jax.random.key(0))
    assert abs(float(out["lml"]) - EXACT) < 0.3
    assert 0.15 < float(out["accept_rate"]) < 0.9


def test_a_vector_latent_keeps_its_shape_through_the_walk():
    @tgx.gen
    def vector_model():
        x = tgx.normal(torch.zeros(2), 1.0) @ "x"
        _ = tgx.normal(x, 0.5) @ "y"

    ns = NestedSampler(
        vector_model, (), tgx.ChoiceMap.kw(y=torch.tensor([1.0, -0.5])), tgx.Selection.at["x"], 50, 60, 3, 0.4
    )
    out = ns.run(torch.Generator().manual_seed(2))
    assert out["dead_choices"]["x"].shape == (60, 2)
    assert out["live_logliks"].shape == (50,)
    assert bool(torch.isfinite(out["lml"]))
