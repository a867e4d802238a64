"""The port's distribution library beyond the particle and VI paths
(`genjax_tpu_torch.distributions.library`: the 38 families that came with
the rest of the library, `sample_shape=`/`Const`, `native_distribution`
and `tfp_distribution`) against `genjax_tpu.distributions`, on the CPU.
The support guards, the records of the reference's faults and the
density gradients are in `test_torch_distribution_support.py`, the
samplers in `test_torch_distribution_samplers.py`.

Densities are compared on grids that hold out-of-support values, with
Python and tensor parameters, at rtol = atol = 1e-6 where both libraries
evaluate the same float32 formula. Three families are held at 1e-5, each
with its reason beside it. Out-of-support values score exactly `-inf` on
both sides.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.distributions import library as J
from genjax_tpu_torch.distributions import library as T

torch.set_num_threads(1)

_R = np.random.default_rng(0)
N_DRAWS = 8192


def f32(x):
    return np.asarray(x, dtype=np.float32)


def line(a, b, k=41):
    return f32(np.linspace(a, b, k))


_U = f32(np.concatenate([np.linspace(-0.5, 1.5, 41), [0.0, 1.0, 1e-6, 1 - 1e-6]]))
_COUNTS = f32(np.arange(-2, 14))

# case -> (name, grid, positional parameters, keyword parameters, tolerance)
GRIDS = {
    "cauchy": ("cauchy", line(-8, 8), (0.5, 2.0), {}, 1e-6),
    "half_cauchy": ("half_cauchy", line(-3, 8), (0.5, 2.0), {}, 1e-6),
    "exp_half_cauchy": ("exp_half_cauchy", line(-6, 6), (1.5,), {}, 1e-6),
    "half_normal": ("half_normal", line(-2, 5), (1.3,), {}, 1e-6),
    "student_t": ("student_t", line(-8, 8), (3.5, 0.5, 1.5), {}, 1e-6),
    "half_student_t": ("half_student_t", line(-3, 8), (3.5, 0.5, 1.5), {}, 1e-6),
    "exponential": ("exponential", line(-1, 6), (1.7,), {}, 1e-6),
    "inverse_gamma": ("inverse_gamma", line(-1, 6), (2.5, 1.5), {}, 1e-6),
    "exp_gamma": ("exp_gamma", line(-6, 3), (2.5, 1.5), {}, 1e-6),
    "exp_inverse_gamma": ("exp_inverse_gamma", line(-3, 4), (2.5, 1.5), {}, 1e-6),
    "chi2": ("chi2", line(-1, 12), (3.0,), {}, 1e-6),
    "chi": ("chi", line(-1, 5), (3.0,), {}, 1e-6),
    "laplace": ("laplace", line(-6, 6), (0.3, 1.2), {}, 1e-6),
    "gumbel": ("gumbel", line(-4, 8), (0.3, 1.2), {}, 1e-6),
    "log_normal": ("log_normal", line(-1, 8), (0.3, 0.8), {}, 1e-6),
    "logit_normal": ("logit_normal", _U, (0.3, 0.8), {}, 1e-6),
    "truncated_normal": ("truncated_normal", line(-3, 4), (0.5, 1.2, -1.0, 2.5), {}, 1e-6),
    "truncated_cauchy": ("truncated_cauchy", line(-3, 4), (0.5, 1.2, -1.0, 2.5), {}, 1e-6),
    "weibull": ("weibull", line(-1, 5), (1.7, 1.3), {}, 1e-6),
    "kumaraswamy": ("kumaraswamy", _U, (2.0, 3.0), {}, 1e-6),
    "double_sided_maxwell": ("double_sided_maxwell", line(-5, 5, 40), (0.25, 1.3), {}, 1e-6),
    "moyal": ("moyal", line(-3, 10), (0.3, 1.2), {}, 1e-6),
    "inverse_gaussian": ("inverse_gaussian", line(-1, 6), (1.5, 2.0), {}, 1e-6),
    "lambert_w_normal": ("lambert_w_normal", line(-10, 10), (0.5, 1.2, 0.3), {}, 1e-6),
    "non_central_chi2": ("non_central_chi2", line(-1, 15), (3.0, 2.0), {}, 1e-6),
    # 2F1 by a float32 series summed in its own order (up to 250 terms):
    # measured 2.2e-6 apart. b1 == b2 here: the reference's density swaps
    # them (R8, `test_beta_quotient_density_r8_reference_and_port`).
    "beta_quotient": ("beta_quotient", line(-0.5, 4), (2.0, 2.5, 1.5, 2.5), {}, 1e-5),
    "von_mises": ("von_mises", line(-3.1, 3.1), (0.5, 2.0), {}, 1e-6),
    # log C(n, k) from three float32 lgammas: the libraries' lgamma differ
    # by an ulp at n + 1 = 11 (measured 1.3e-6 and 1.8e-6 apart).
    "binomial": ("binomial", _COUNTS, (10.0, 0.3), {}, 1e-5),
    "binomial_logits": ("binomial", _COUNTS, (10.0,), {"logits": -0.4}, 1e-5),
    "beta_binomial": ("beta_binomial", _COUNTS, (10.0, 2.0, 3.0), {}, 1e-5),
    "poisson": ("poisson", _COUNTS, (3.5,), {}, 1e-6),
    "negative_binomial": ("negative_binomial", _COUNTS, (4.0,), {"probs": 0.4}, 1e-6),
    "negative_binomial_logits": ("negative_binomial", _COUNTS, (4.0,), {"logits": -0.3}, 1e-6),
    "skellam": ("skellam", f32(np.arange(-8, 9)), (2.5, 1.5), {}, 1e-6),
    "zipf": ("zipf", f32(np.arange(-1, 15)), (2.5,), {}, 1e-6),
}


def _jax_logpdf(name, v, params, kw):
    return np.asarray(
        getattr(J, name).logpdf(jnp.asarray(v), *[jnp.asarray(p) for p in params], **{k: jnp.asarray(x) for k, x in kw.items()})
    )


def _as_torch(p, as_tensor: bool):
    if isinstance(p, np.ndarray):
        return torch.from_numpy(p)
    return torch.tensor(p) if as_tensor else p


def _agree(got, ref, tol):
    got = np.broadcast_to(got, ref.shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == -np.inf, ref == -np.inf)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_the_port_exports_every_distribution_name_of_the_reference():
    import genjax_tpu.distributions as jd
    import genjax_tpu_torch.distributions as td

    assert set(jd.__all__) <= set(td.__all__), sorted(set(jd.__all__) - set(td.__all__))
    for name in jd.__all__:
        assert hasattr(tgx, name) or name in ("Distribution", "DistributionTrace", "ExactDensity", "exact_density")
    assert tgx.Const is not None and hasattr(jgx, "Const")


@functools.cache
def _grid_reference(case):
    name, v, params, kw, _ = GRIDS[case]
    return _jax_logpdf(name, v, params, kw)


@pytest.mark.parametrize("params_as_tensors", [False, True], ids=["python_params", "tensor_params"])
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_logpdf_matches_jax(case, params_as_tensors):
    name, v, params, kw, tol = GRIDS[case]
    ref = _grid_reference(case)
    got = getattr(T, name).logpdf(
        torch.from_numpy(v),
        *[_as_torch(p, params_as_tensors) for p in params],
        **{k: _as_torch(x, params_as_tensors) for k, x in kw.items()},
    )
    _agree(got.numpy(), ref, tol)


_MU = f32([0.6, 0.0, 0.8])
_SPHERE = _R.standard_normal((16, 3))
_SPHERE = f32(_SPHERE / np.linalg.norm(_SPHERE, axis=-1, keepdims=True))


@pytest.mark.parametrize("kappa", [0.5, 3.0, 40.0])
@pytest.mark.parametrize("name", ["von_mises_fisher", "power_spherical"])
def test_directional_logpdf_matches_jax_also_per_particle(name, kappa):
    # vMF's log I_v(kappa) is a 40-term float32 series (or Olver's form past
    # kappa = v^2 / 2 + 20) summed in each library's own order: measured
    # 3.0e-6 apart at concentrations up to 40. The power-spherical norm is a
    # difference of lgammas near 110 at kappa = 40, whose float32 ulp is
    # 7.6e-6: measured 1.1e-5 apart.
    tol = 1e-5 if name == "von_mises_fisher" else 2e-5
    ref = _jax_logpdf(name, _SPHERE, (_MU, kappa), {})
    _agree(getattr(T, name).logpdf(torch.from_numpy(_SPHERE), torch.from_numpy(_MU), kappa).numpy(), ref, tol)
    # One mean direction and concentration per row (particle), against
    # JAX's vmap of the same density.
    mus = _R.standard_normal((16, 3))
    mus = f32(mus / np.linalg.norm(mus, axis=-1, keepdims=True))
    kappas = f32(_R.uniform(0.1, kappa, 16))
    ref = np.asarray(jax.vmap(getattr(J, name).logpdf)(jnp.asarray(_SPHERE), jnp.asarray(mus), jnp.asarray(kappas)))
    got = getattr(T, name).logpdf(torch.from_numpy(_SPHERE), torch.from_numpy(mus), torch.from_numpy(kappas))
    _agree(got.numpy(), ref, tol)


def test_mv_normal_logpdf_matches_jax_with_a_shared_and_per_particle_covariance():
    A = _R.standard_normal((3, 3))
    cov = f32(A @ A.T + np.eye(3))
    loc = f32([0.5, -1.0, 2.0])
    vs = f32(_R.standard_normal((16, 3)))
    ref = np.asarray(jax.vmap(lambda v: J.mv_normal.logpdf(v, jnp.asarray(loc), jnp.asarray(cov)))(jnp.asarray(vs)))
    _agree(T.mv_normal.logpdf(torch.from_numpy(vs), torch.from_numpy(loc), torch.from_numpy(cov)).numpy(), ref, 1e-6)
    Bs = _R.standard_normal((16, 3, 3))
    covs = f32(Bs @ np.swapaxes(Bs, -1, -2) + np.eye(3))
    ref = np.asarray(jax.vmap(lambda v, c: J.mv_normal.logpdf(v, jnp.asarray(loc), c))(jnp.asarray(vs), jnp.asarray(covs)))
    got = T.mv_normal.logpdf(torch.from_numpy(vs), torch.from_numpy(loc), torch.from_numpy(covs))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)  # sixteen float32 Cholesky factors


def test_mv_normal_with_a_covariance_that_is_not_positive_definite_is_nan_as_in_jax():
    # One positive-definite and one indefinite (eigenvalues 3 and -1)
    # covariance: JAX's Cholesky factor of the second is NaN, and so are
    # the density and the draws the port makes with it.
    covs = f32([[[2.0, 0.5], [0.5, 1.0]], [[1.0, 2.0], [2.0, 1.0]]])
    loc, vs = f32([0.5, -1.0]), f32([[0.3, 0.1], [-0.2, 0.4]])
    ref = np.asarray(jax.vmap(lambda v, c: J.mv_normal.logpdf(v, jnp.asarray(loc), c))(jnp.asarray(vs), jnp.asarray(covs)))
    got = T.mv_normal.logpdf(torch.from_numpy(vs), torch.from_numpy(loc), torch.from_numpy(covs)).numpy()
    assert np.isfinite(ref[0]) and np.isnan(ref[1])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)  # NaN where JAX's is NaN
    draws = T.mv_normal.sample(torch.Generator().manual_seed(0), torch.from_numpy(loc), torch.from_numpy(covs[1]))
    assert draws.shape == (2,) and bool(torch.isnan(draws).all())
    assert bool(torch.isnan(T.mv_normal.logpdf(torch.from_numpy(vs[0]), torch.from_numpy(loc), torch.from_numpy(covs[1]))))


_COUNT_VECTORS = f32([[2, 3, 5], [0, 0, 10], [10, 0, 0], [-1, 6, 5], [2, 2, 2], [4, 4, 2], [11, 0, -1]])


@pytest.mark.parametrize(
    "name,params,kw",
    [
        ("multinomial", (10.0, f32([0.2, 0.3, 0.5])), {}),
        ("multinomial", (10.0,), {"logits": f32([0.2, -0.3, 0.5])}),
        ("dirichlet_multinomial", (10.0, f32([1.2, 0.7, 2.5])), {}),
    ],
)
def test_count_vector_logpdf_matches_jax(name, params, kw):
    ref = _jax_logpdf(name, _COUNT_VECTORS, params, kw)
    got = getattr(T, name).logpdf(
        torch.from_numpy(_COUNT_VECTORS), *[_as_torch(p, True) for p in params], **{k: torch.from_numpy(x) for k, x in kw.items()}
    )
    _agree(got.numpy(), ref, 1e-6)
    assert (ref == -np.inf).sum() == 3


def test_sample_shape_and_const_against_jax_vmap():
    # `normal(..., sample_shape=Const((3,)))` and a categorical of N draws
    # from one row of logits, scored by both packages on the same choices.
    K, N = 3, 5

    @jgx.gen
    def jmodel(logits):
        m = jgx.normal(0.0, 10.0, sample_shape=jgx.Const((K,))) @ "means"
        _ = jgx.categorical(logits=logits, sample_shape=jgx.Const((N,))) @ "idx"
        return m

    @tgx.gen
    def tmodel(logits):
        m = tgx.normal(0.0, 10.0, sample_shape=tgx.Const((K,))) @ "means"
        _ = tgx.categorical(logits=logits, sample_shape=tgx.Const((N,))) @ "idx"
        return m

    logits = f32([0.2, -1.0, 0.5])
    tr = tmodel.simulate(torch.Generator().manual_seed(0), (torch.from_numpy(logits),))
    chm = tr.get_choices()
    assert chm["means"].shape == (K,) and chm["idx"].shape == (N,) and chm["idx"].dtype == torch.int64
    ref, _ = jmodel.assess(jgx.ChoiceMap.d({"means": jnp.asarray(chm["means"].numpy()), "idx": jnp.asarray(chm["idx"].numpy())}), (jnp.asarray(logits),))
    np.testing.assert_allclose(float(tr.get_score()), float(ref), rtol=1e-6)

    # Under n particles, per-particle logits (n, K): the draw is (n, N),
    # its score one per particle, as JAX's vmap of the same site gives.
    n = 4
    rows = f32(_R.standard_normal((n, K)))
    trn = tmodel.simulate(torch.Generator().manual_seed(1), (tgx.per_particle(torch.from_numpy(rows)),), n=n)
    choices = trn.get_choices()
    assert choices["means"].shape == (n, K) and choices["idx"].shape == (n, N)
    ref = jax.vmap(
        lambda m, i, lg: jmodel.assess(jgx.ChoiceMap.d({"means": m, "idx": i}), (lg,))[0]
    )(jnp.asarray(choices["means"].numpy()), jnp.asarray(choices["idx"].numpy()), jnp.asarray(rows))
    np.testing.assert_allclose(trn.get_score().numpy(), np.asarray(ref), rtol=1e-6)
    # Shared logits under particles: still (n, N) draws.
    trs = tmodel.simulate(torch.Generator().manual_seed(2), (torch.from_numpy(logits),), n=n)
    assert trs.get_choices()["idx"].shape == (n, N) and trs.get_score().shape == (n,)
    # Update of the sample-shaped site reweights by the change of its score.
    new_idx = torch.zeros(N, dtype=torch.int64)
    tr2, w, _, _ = tr.update(torch.Generator(), tgx.ChoiceMap.kw(idx=new_idx))
    np.testing.assert_allclose(float(w), float(tr2.get_score() - tr.get_score()), rtol=1e-6)
    np.testing.assert_allclose(
        float(tr2.get_score()),
        float(jmodel.assess(jgx.ChoiceMap.d({"means": jnp.asarray(chm["means"].numpy()), "idx": jnp.zeros(N, jnp.int32)}), (jnp.asarray(logits),))[0]),
        rtol=1e-6,
    )


def test_sample_shape_of_a_vector_site_under_particles():
    # A Dirichlet of per-particle concentrations, two draws per particle:
    # (n, 2, K) values, the score summed over the sample axis only.
    n, K = 4, 3
    conc = torch.from_numpy(f32(_R.uniform(0.5, 3.0, (n, K))))

    @tgx.gen
    def model(c):
        return tgx.dirichlet(c, sample_shape=(2,)) @ "p"

    tr = model.simulate(torch.Generator().manual_seed(3), (tgx.per_particle(conc),), n=n)
    v = tr.get_choices()["p"]
    assert v.shape == (n, 2, K)
    ref = jax.vmap(lambda x, c: jnp.sum(jax.vmap(lambda xi: J.dirichlet.logpdf(xi, c))(x)))(
        jnp.asarray(v.numpy()), jnp.asarray(conc.numpy())
    )
    np.testing.assert_allclose(tr.get_score().numpy(), np.asarray(ref), rtol=1e-5)


class ShiftedExponential:
    """A hand-rolled TFP-style distribution: loc + Exp(rate)."""

    def __init__(self, loc, rate):
        self.loc = loc
        self.rate = rate

    def sample(self, seed=None, sample_shape=()):
        return self.loc + torch.empty(sample_shape).exponential_(generator=seed) / self.rate

    def log_prob(self, v):
        z = v - self.loc
        return torch.where(z >= 0, math.log(self.rate) - self.rate * z, -math.inf)


shifted_exp = T.tfp_distribution(ShiftedExponential, name="shifted_exponential")


def test_tfp_distribution_like_the_jax_shim():
    # The four cases of `tests/distributions/test_tfp_shim.py`.
    tr = shifted_exp.simulate(torch.Generator().manual_seed(0), (1.0, 2.0))
    v = float(tr.get_retval())
    assert v >= 1.0
    assert math.isclose(float(tr.get_score()), math.log(2.0) - 2.0 * (v - 1.0), abs_tol=1e-6)

    @tgx.gen
    def model():
        x = shifted_exp(0.0, 1.0) @ "x"
        return tgx.normal(x, 1.0) @ "y"

    sc, _ = model.assess(tgx.ChoiceMap.kw(x=0.5, y=1.0), ())
    assert math.isclose(float(sc), -0.5 + (-0.5 * 0.25 - 0.5 * math.log(2 * math.pi)), abs_tol=1e-5)
    vs = shifted_exp.simulate(torch.Generator().manual_seed(1), (1.0, 2.0), n=4000).get_retval()
    assert vs.shape == (4000,) and abs(float(vs.mean()) - 1.5) < 0.05
    tr, w = shifted_exp.importance(torch.Generator(), tgx.ChoiceMap.choice(2.0), (1.0, 2.0))
    assert math.isclose(float(w), math.log(2.0) - 2.0, abs_tol=1e-6)
    # Keyword parameters bind by the constructor's signature.
    assert shifted_exp(rate=2.0, loc=1.0).args == (1.0, 2.0)


def test_native_distribution_binds_keywords_and_defaults():
    assert T.native_distribution is T.exact_density
    closure = T.exp_gamma(2.5)
    assert closure.args == (2.5,)
    assert T.exp_gamma(concentration=2.5).args == (2.5, 1.0)
    assert T.binomial(10.0, logits=-0.3).args == (10.0, None, -0.3)
    ref = float(J.binomial.logpdf(3.0, 10.0, logits=-0.3))
    assert math.isclose(float(T.binomial.logpdf(3.0, total_count=10.0, logits=-0.3)), ref, rel_tol=1e-5)

