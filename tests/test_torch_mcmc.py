"""The MCMC path's deterministic pieces, port (`genjax_tpu_torch`) against
JAX (`genjax_tpu`) on the CPU, on the same numpy-made chain batches:
`assess` scores and `selection_gradient` of logistic and polynomial
regression, `Update` weights and new scores, `project`, and the HMC and
MALA cores fed the momenta and the noise that JAX's `HMC.edit` and
`MALA.edit` draw from their keys.

JAX runs one chain per `vmap` lane; the port runs the batch at once. Both
compute in float32, summing in different orders, so each comparison
states its tolerance: 1e-5 of the largest magnitude compared (of the
largest |score| for an accept ratio, a difference of scores).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx
from genjax_tpu.inference.requests.hmc import HMC as JaxHMC
from genjax_tpu.inference.requests.hmc import MALA as JaxMALA
from genjax_tpu.inference.requests.hmc import selection_gradient as jax_selection_gradient
from genjax_tpu.models.logreg import logistic_regression as jax_logreg
from genjax_tpu.models.polyreg import polynomial_regression as jax_polyreg
from genjax_tpu_torch import convert
from genjax_tpu_torch.inference.requests.hmc import selection_gradient
from genjax_tpu_torch.models.logreg import logistic_regression
from genjax_tpu_torch.models.polyreg import polynomial_regression

torch.set_num_threads(1)

C = 32  # chains
N, D = 100, 4  # logistic regression: data points, dimensions
NP = 20  # polynomial regression: design points


def _logreg_case(seed: int = 0, n: int = N, c: int = C):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D)).astype(np.float32)
    w_true = rng.standard_normal(D).astype(np.float32)
    ys = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ w_true))).astype(np.int32)
    w = (0.5 * rng.standard_normal((c, D))).astype(np.float32)
    return {"w": w}, {"ys": ys}, (X,), "w", jax_logreg, logistic_regression


def _polyreg_case(seed: int = 1, n: int = NP, c: int = C):
    rng = np.random.default_rng(seed)
    xs = np.linspace(-2.0, 2.0, n).astype(np.float32)
    ys = (0.5 - xs + 0.3 * xs**2 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    coeffs = (rng.standard_normal((c, 3))).astype(np.float32)
    return {"coeffs": coeffs}, {"ys": ys}, (xs, 0.3), "coeffs", jax_polyreg, polynomial_regression


CASES = {"logreg": _logreg_case, "polyreg": _polyreg_case}


def _jax_args(args):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)


def _jax_traces(case):
    """JAX's chain batch: one fully constrained `importance` per vmap lane."""
    per_chain, shared, args, addr, jax_model, _ = case
    obs = {k: jnp.asarray(v) for k, v in shared.items()}

    def one(v):
        chm = jgx.ChoiceMap.d({addr: v, **obs})
        return jax_model.importance(jax.random.key(0), chm, _jax_args(args))[0]

    return jax.vmap(one)(jnp.asarray(per_chain[addr]))


def _port_traces(case):
    per_chain, shared, args, _, _, model = case
    return convert.chain_batch(model, args, per_chain, shared, device="cpu")


def _close(got, ref, rtol):
    """Within `rtol` of the largest |ref| (at least 1)."""
    ref = np.asarray(ref, dtype=np.float64)
    _close_abs(got, ref, rtol * max(1.0, np.abs(ref).max()))


def _close_abs(got, ref, atol):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _score_scale(jtr) -> float:
    return float(np.abs(np.asarray(jtr.get_score())).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_assess_scores_and_selection_gradient_match_vmapped_jax(name):
    case = CASES[name]()
    per_chain, shared, args, addr, jax_model, model = case

    def density(v):
        chm = jgx.ChoiceMap.d({addr: v, **{k: jnp.asarray(x) for k, x in shared.items()}})
        return jax_model.assess(chm, _jax_args(args))[0]

    ref_score, ref_grad = jax.vmap(jax.value_and_grad(density))(jnp.asarray(per_chain[addr]))
    chm = tgx.ChoiceMap.d({addr: tgx.per_particle(torch.from_numpy(per_chain[addr]))})
    chm = chm | convert.choice_map(shared, "cpu")
    targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    score, _ = model.assess(chm, targs, C)
    # One float32 density pass: 1e-5 of the largest |score|.
    _close(score.numpy(), ref_score, 1e-5)

    tr = _port_traces(case)
    values, grad = selection_gradient(tgx.Selection.at[addr], tr, tgx.Diff.no_change(tr.get_args()))
    np.testing.assert_array_equal(values[addr].numpy(), per_chain[addr])
    # One forward and backward pass: 1e-5 of the largest |gradient|.
    _close(grad[addr].numpy(), ref_grad, 1e-5)
    # JAX's own selection_gradient on its chain batch agrees as well.
    jtr = _jax_traces(case)
    _, jgrad = jax.vmap(
        lambda t: jax_selection_gradient(jgx.Selection.at[addr], t, jgx.Diff.no_change(t.get_args()))
    )(jtr)
    _close(grad[addr].numpy(), jgrad[addr], 1e-5)
    _close(tr.get_score().numpy(), jtr.get_score(), 1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_update_weights_and_new_scores_match_jax(name):
    case = CASES[name]()
    per_chain, _, _, addr, _, _ = case
    new_vals = (per_chain[addr] + 0.1 * np.random.default_rng(9).standard_normal(per_chain[addr].shape)).astype(
        np.float32
    )
    jtr = _jax_traces(case)
    jnew, jw, _, jdiscard = jax.vmap(
        lambda t, v: t.update(jax.random.key(1), jgx.ChoiceMap.d({addr: v}))
    )(jtr, jnp.asarray(new_vals))

    tr = _port_traces(case)
    constraint = tgx.ChoiceMap.d({addr: tgx.per_particle(torch.from_numpy(new_vals))})
    new, w, _, discard = tr.update(torch.Generator(), constraint)
    # Scores of one density pass each: 1e-5 of the largest |score|.
    _close(new.get_score().numpy(), jnew.get_score(), 1e-5)
    _close(w.numpy(), jw, 1e-5)
    np.testing.assert_array_equal(discard[addr].numpy(), np.asarray(jdiscard[addr]))
    np.testing.assert_array_equal(new.get_choices()[addr].numpy(), new_vals)
    # The shared leaves are the old trace's own objects.
    assert new.get_args()[0] is tr.get_args()[0]
    assert new.get_choices()["ys"] is tr.get_choices()["ys"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_project_matches_jax(name):
    case = CASES[name]()
    addr = case[3]
    jtr, tr = _jax_traces(case), _port_traces(case)
    for sel_j, sel_t in [
        (jgx.Selection.at[addr], tgx.Selection.at[addr]),
        (jgx.Selection.at["ys"], tgx.Selection.at["ys"]),
        (jgx.Selection.all(), tgx.Selection.all()),
    ]:
        ref = jax.vmap(lambda t: t.project(jax.random.key(0), sel_j))(jtr)
        got = tr.project(torch.Generator(), sel_t)
        # Sums of one density pass: 1e-5 of the largest |score|.
        _close(np.broadcast_to(got.numpy(), ref.shape), ref, 1e-5)


def _inv_mass(kind: str, dim: int, addr: str):
    """(JAX's inv_mass, the port's) of one kind: unit (None), one scalar,
    or a diagonal given as a tree matching the selected choices."""
    if kind == "unit":
        return None, None
    if kind == "scalar":
        return 0.5, 0.5
    diag = np.linspace(0.5, 2.0, dim).astype(np.float32)
    return jgx.ChoiceMap.d({addr: jnp.asarray(diag)}), tgx.ChoiceMap.d({addr: torch.from_numpy(diag)})


@pytest.mark.parametrize(
    "mass,jitter",
    [("unit", 0.0), ("unit", 0.3), ("scalar", 0.0), ("diagonal", 0.3)],
    ids=["unit_mass", "unit_mass_jittered", "scalar_mass", "diagonal_mass_jittered"],
)
@pytest.mark.parametrize("name", sorted(CASES))
def test_hmc_core_fed_jax_momenta_matches_jax_edit(name, mass, jitter):
    case = CASES[name]()
    addr = case[3]
    dim = case[0][addr].shape[1]
    # Polyreg's posterior is the narrower (its scores reach thousands): a
    # smaller step keeps every trajectory from diverging.
    eps, L = (0.05 if name == "logreg" else 0.01), 5
    im_j, im_t = _inv_mass(mass, dim, addr)
    jtr = _jax_traces(case)
    keys = jax.random.split(jax.random.key(7), C)
    request = JaxHMC(jgx.Selection.at[addr], jnp.asarray(eps), L=L, inv_mass=im_j, jitter=jitter)
    jnew, jalpha, _, _ = jax.vmap(lambda k, t: request.edit(k, t, jgx.Diff.no_change(t.get_args())))(keys, jtr)

    # The draws inside JAX's edit (hmc.py:214-233): the momenta from the
    # first split of the key, folded in with the leaf's index 0 and scaled
    # by 1 / sqrt(inv_mass); the jitter uniform from the second split of
    # what is left.
    std = 1.0 if im_j is None else (1.0 / np.sqrt(im_j) if mass == "scalar" else 1.0 / jnp.sqrt(im_j[addr]))

    def draws(k):
        k, sub = jax.random.split(k)
        p = jax.random.normal(jax.random.fold_in(sub, 0), (dim,)) * std
        _, jit_key = jax.random.split(k)
        return p, jax.random.uniform(jit_key)

    momenta, u = jax.vmap(draws)(keys)
    tr = _port_traces(case)
    m = tgx.ChoiceMap.d({addr: tgx.per_particle(torch.tensor(np.asarray(momenta)))})
    step = eps * (1.0 + jitter * (2.0 * torch.tensor(np.asarray(u)) - 1.0)) if jitter else eps
    new, alpha, _, _ = tgx.HMC(tgx.Selection.at[addr], eps, L=L, inv_mass=im_t, jitter=jitter).edit_with(
        torch.Generator(), tr, m, step
    )
    # L = 5 leapfrog steps of float32: values to 1e-5 (measured: 7e-7);
    # alpha, a difference of scores, to 1e-5 of the largest |score|
    # (measured: 2e-7 of it).
    _close(new.get_choices()[addr].numpy(), jnew.get_choices()[addr], 1e-5)
    _close_abs(alpha.numpy(), jalpha, 1e-5 * _score_scale(jtr))


@pytest.mark.parametrize("mass", ["unit", "diagonal"], ids=["unit_mass", "diagonal_mass"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mala_core_fed_jax_noise_matches_jax_edit(name, mass):
    case = CASES[name]()
    addr = case[3]
    eps = 1e-3
    im_j, im_t = _inv_mass(mass, case[0][addr].shape[1], addr)
    jtr = _jax_traces(case)
    keys = jax.random.split(jax.random.key(8), C)
    request = JaxMALA(jgx.Selection.at[addr], jnp.asarray(eps), inv_mass=im_j)
    jnew, jalpha, _, _ = jax.vmap(lambda k, t: request.edit(k, t, jgx.Diff.no_change(t.get_args())))(keys, jtr)

    def noise(k):  # hmc.py:310-319: the second split, folded in with leaf 0
        _, noise_key = jax.random.split(k)
        return jax.random.normal(jax.random.fold_in(noise_key, 0), (case[0][addr].shape[1],))

    xi = jax.vmap(noise)(keys)
    tr = _port_traces(case)
    n = tgx.ChoiceMap.d({addr: tgx.per_particle(torch.tensor(np.asarray(xi)))})
    new, alpha, _, _ = tgx.MALA(tgx.Selection.at[addr], eps, inv_mass=im_t).edit_with(torch.Generator(), tr, n)
    # One Langevin step: values to 1e-5; alpha, a difference of scores
    # plus two kernel terms, to 1e-5 of the largest |score|.
    _close(new.get_choices()[addr].numpy(), jnew.get_choices()[addr], 1e-5)
    _close_abs(alpha.numpy(), jalpha, 1e-5 * _score_scale(jtr))


def test_regenerate_weight_is_the_score_change_and_its_backward_update_returns():
    case = _logreg_case(seed=4)
    tr = _port_traces(case)
    sel = tgx.Selection.at["w"]
    new, w, _, bwd = tr.edit(torch.Generator().manual_seed(0), tgx.Regenerate(sel))
    assert not torch.equal(new.get_choices()["w"], tr.get_choices()["w"])
    assert new.get_choices()["ys"] is tr.get_choices()["ys"]
    # JAX's Regenerate weight (distribution.py:258-300): the change of the
    # joint score, which `mh` corrects with `project`. The weight sums the
    # sites' changes, the difference the totals: 1e-5 of the largest |score|.
    atol = 1e-5 * float(tr.get_score().abs().max())
    torch.testing.assert_close(w, new.get_score() - tr.get_score(), rtol=0, atol=atol)
    back, w_back, _, _ = new.edit(torch.Generator(), bwd)
    torch.testing.assert_close(back.get_choices()["w"], tr.get_choices()["w"], rtol=0, atol=0)
    torch.testing.assert_close(w_back, -w, rtol=0, atol=atol)
    same, w0, _, _ = tr.edit(torch.Generator(), tgx.EmptyRequest())
    assert same is tr and float(w0) == 0.0


def test_bernoulli_and_mv_normal_diag_densities_match_jax():
    rng = np.random.default_rng(12)
    logits = (4.0 * rng.standard_normal(50)).astype(np.float32)
    probs = rng.uniform(0.01, 0.99, 50).astype(np.float32)
    v = rng.integers(0, 2, 50).astype(np.int32)
    v[:3] = [2, -1, 0]  # out of the support {0, 1}, then in it
    for kw in ({"logits": logits}, {"probs": probs}):
        ref = np.asarray(jgx.bernoulli.logpdf(jnp.asarray(v), **{k: jnp.asarray(x) for k, x in kw.items()}))
        got = tgx.bernoulli.logpdf(torch.from_numpy(v), **{k: torch.from_numpy(x) for k, x in kw.items()}).numpy()
        np.testing.assert_array_equal(got == -np.inf, ref == -np.inf)
        # One float32 density each: 1e-5 of the largest finite |ref|.
        finite = np.isfinite(ref)
        _close(got[finite], ref[finite], 1e-5)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    loc, scale = rng.standard_normal(5).astype(np.float32), rng.uniform(0.5, 2.0, 5).astype(np.float32)
    ref = jax.vmap(lambda xi: jgx.mv_normal_diag.logpdf(xi, jnp.asarray(loc), jnp.asarray(scale)))(jnp.asarray(x))
    got = tgx.mv_normal_diag.logpdf(torch.from_numpy(x), torch.from_numpy(loc), torch.from_numpy(scale))
    _close(got.numpy(), ref, 1e-5)
    # Draws: int32 in {0, 1} at the rate sigmoid(logits) (5 SE).
    draws = tgx.bernoulli.sample(torch.Generator().manual_seed(0), torch.tensor(0.3), n=20_000)
    p = 1.0 / (1.0 + np.exp(-0.3))
    assert draws.dtype == torch.int32 and set(draws.unique().tolist()) <= {0, 1}
    assert abs(float(draws.double().mean()) - p) < 5 * np.sqrt(p * (1 - p) / 20_000)


def test_chain_batch_carried_from_jax_has_the_jax_scores():
    case = _logreg_case(seed=3)
    jtr = _jax_traces(case)
    w = np.asarray(jtr.get_choices()["w"])
    tr = convert.chain_batch(logistic_regression, case[2], {"w": w}, case[1], device="cpu")
    # One density pass: 1e-5 of the largest |score|.
    _close(tr.get_score().numpy(), jtr.get_score(), 1e-5)
    assert tr.get_args()[0].shape == (N, D) and tr.get_choices()["ys"].shape == (N,)
    assert tr.particle_count() == C
