"""Log densities and samplers of the port's distributions
(`genjax_tpu_torch.distributions`: the particle path's, and gamma,
dirichlet and geometric of the VI path) against
`genjax_tpu.distributions`.

Every grid holds out-of-support values, which must score exactly `-inf`
on both sides. Densities agree to rtol = atol = 1e-6: both evaluate the
same float32 formulas; where a large concentration magnifies the ulp
by which the libraries' `log` and `lgamma` differ, the test says so.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.distributions import library as jax_lib
from genjax_tpu_torch.distributions import library as torch_lib

torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
_U = np.concatenate([np.linspace(-0.5, 1.5, 41), [0.0, 1.0, 1e-6, 1 - 1e-6]]).astype(np.float32)

GRIDS = {
    "normal": ("normal", np.linspace(-6, 6, 49).astype(np.float32), (0.3, 1.7)),
    "normal_batched": (
        "normal",
        _RNG.standard_normal(64).astype(np.float32),
        (_RNG.standard_normal(64).astype(np.float32), _RNG.uniform(0.2, 3, 64).astype(np.float32)),
    ),
    "uniform": ("uniform", np.linspace(-1, 3, 41).astype(np.float32), (0.5, 2.0)),
    "beta_int": ("beta", _U, (2.0, 3.0)),
    "beta_fractional": ("beta", _U, (0.7, 2.5)),
    "flip_values": (
        "flip",
        np.array([0.0, 1.0, 0.5, 2.0, -1.0, 1.0, 0.0], dtype=np.float32),
        (np.array([0.3, 0.3, 0.3, 0.3, 0.3, 0.0, 1.0], dtype=np.float32),),
    ),
    "flip_bool": ("flip", np.array([True, False, True, False]), (np.array([0.9, 0.9, 1e-7, 1.0], dtype=np.float32),)),
    "gamma": ("gamma", np.concatenate([np.linspace(-1, 6, 36), [0.0, 1e-6]]).astype(np.float32), (2.5, 1.5)),
    "gamma_shape_one": ("gamma", np.array([-1.0, 0.0, 0.5, 3.0], dtype=np.float32), (1.0, 2.0)),
    "gamma_small_shape": ("gamma", np.array([-0.5, 1e-3, 0.2, 2.0], dtype=np.float32), (0.5, 0.7)),
    "dirichlet": (
        "dirichlet",
        np.concatenate(
            [_RNG.dirichlet([1.0, 2.0, 3.0], 16), [[0.0, 0.5, 0.5], [-0.1, 0.6, 0.5], [1.2, -0.1, -0.1]]]
        ).astype(np.float32),
        (np.array([1.0, 2.0, 3.0], dtype=np.float32),),
    ),
    # Integer counts only: a non-integer count is fault R3 of the
    # reference (`test_geometric_non_integer_count_reference_and_port`).
    "geometric_logits": ("geometric", np.arange(-3, 12).astype(np.float32), (-0.4,)),
}


def _torch_arg(a, as_tensor: bool):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a)
    return torch.tensor(a) if as_tensor else a


@pytest.mark.parametrize("params_as_tensors", [False, True], ids=["python_params", "tensor_params"])
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_logpdf_matches_jax(case, params_as_tensors):
    name, v, params = GRIDS[case]
    ref = np.asarray(getattr(jax_lib, name).logpdf(jnp.asarray(v), *[jnp.asarray(p) for p in params]))
    got = getattr(torch_lib, name).logpdf(
        torch.from_numpy(v), *[_torch_arg(p, params_as_tensors) for p in params]
    )
    got = np.broadcast_to(got.numpy(), ref.shape)
    assert got.dtype == np.float32
    # Out of support (and zero-density boundaries): exactly -inf on both.
    np.testing.assert_array_equal(got == -np.inf, ref == -np.inf)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if name != "normal":
        assert (ref == -np.inf).any()


def test_beta_logpdf_with_large_or_per_particle_concentrations():
    # The two libraries' float32 `log` and `lgamma` differ by an ulp or
    # two, and a concentration c multiplies the log's error by c - 1
    # (measured: up to 3.4e-6 apart for concentrations below 6), so this
    # grid is held at atol = 1e-5; the support semantics stay exact.
    v = _RNG.uniform(-0.2, 1.2, 256).astype(np.float32)
    a = _RNG.uniform(0.5, 6, 256).astype(np.float32)
    b = _RNG.uniform(0.5, 6, 256).astype(np.float32)
    ref = np.asarray(jax_lib.beta.logpdf(jnp.asarray(v), jnp.asarray(a), jnp.asarray(b)))
    got = torch_lib.beta.logpdf(torch.from_numpy(v), torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got == -np.inf, ref == -np.inf)
    assert (ref == -np.inf).any()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def _moments_within(x: torch.Tensor, mean: float, var: float, n_se: float = 5.0):
    x = x.double()
    se_mean = x.std() / np.sqrt(x.numel())
    sq = (x - mean) ** 2
    se_var = sq.std() / np.sqrt(x.numel())
    assert abs(float(x.mean()) - mean) < n_se * float(se_mean)
    assert abs(float(sq.mean()) - var) < n_se * float(se_var)


def test_beta_2_2_fast_path_is_the_middle_of_three_uniforms_with_the_right_moments():
    n = 200_000
    draws = torch_lib.beta.sample(torch.Generator().manual_seed(1), 2.0, 2.0, n=n)
    u = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(draws, u.median(dim=-1).values, rtol=0, atol=0)
    # Beta(2, 2): mean 1/2, variance 1/20; checked at 5 standard errors.
    _moments_within(draws, 0.5, 0.05)


def test_beta_fast_path_reads_only_host_values():
    # A 0-d CPU tensor takes the order-statistic path like a Python number;
    # a particle column of concentrations takes the gamma ratio.
    a = torch.tensor(2.0)
    x = torch_lib.beta.sample(torch.Generator().manual_seed(2), a, a, n=8)
    y = torch_lib.beta.sample(torch.Generator().manual_seed(2), 2.0, 2.0, n=8)
    torch.testing.assert_close(x, y, rtol=0, atol=0)
    col = torch.full((100_000,), 2.5)
    z = torch_lib.beta.sample(torch.Generator().manual_seed(3), col, torch.full((100_000,), 1.5))
    # Beta(2.5, 1.5): mean 5/8, variance ab / ((a+b)^2 (a+b+1)) = 3.75/80.
    _moments_within(z, 0.625, 3.75 / 80.0)


@pytest.mark.parametrize(
    "name,params,mean,var",
    [
        ("normal", (1.5, 0.5), 1.5, 0.25),
        ("uniform", (-1.0, 3.0), 1.0, 16.0 / 12.0),
        ("flip", (0.3,), 0.3, 0.21),
        # Gamma(c, rate r): mean c / r, variance c / r^2.
        ("gamma", (2.5, 1.5), 2.5 / 1.5, 2.5 / 2.25),
        ("gamma", (0.4, 2.0), 0.2, 0.1),
    ],
)
def test_sampler_moments(name, params, mean, var):
    draws = getattr(torch_lib, name).sample(torch.Generator().manual_seed(4), *params, n=100_000)
    _moments_within(draws.float(), mean, var)


def test_geometric_sampler_moments():
    # Failures before the first success: mean (1 - p) / p, variance (1 - p) / p^2.
    p = 0.3
    draws = torch_lib.geometric.sample(torch.Generator().manual_seed(5), probs=torch.tensor(p), n=100_000)
    assert draws.dtype == torch.int32 and int(draws.min()) >= 0
    _moments_within(draws.float(), (1 - p) / p, (1 - p) / p**2)


def test_dirichlet_sampler_moments():
    # Component i: mean a_i / A, variance a_i (A - a_i) / (A^2 (A + 1)).
    a = torch.tensor([1.0, 2.0, 3.0])
    draws = torch_lib.dirichlet.sample(torch.Generator().manual_seed(6), a, n=100_000)
    torch.testing.assert_close(draws.sum(-1), torch.ones(100_000), rtol=0, atol=1e-5)
    total = float(a.sum())
    for i in range(3):
        ai = float(a[i])
        _moments_within(draws[:, i], ai / total, ai * (total - ai) / (total**2 * (total + 1)))


def test_geometric_non_integer_count_reference_and_port():
    # R3: the reference scores a non-integer count finitely (its logpdf
    # checks only v >= 0); the port takes `_guard_support`'s documented
    # semantics and scores it -inf. Integer counts agree (GRIDS).
    v = np.array([1.5, 0.25, 2.0], dtype=np.float32)
    ref = np.asarray(jax_lib.geometric.logpdf(jnp.asarray(v), probs=jnp.float32(0.3)))
    got = torch_lib.geometric.logpdf(torch.from_numpy(v), probs=torch.tensor(0.3)).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_array_equal(got[:2], [-np.inf, -np.inf])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6)


@pytest.mark.parametrize(
    "name,v,params",
    [
        ("gamma", 0.0, (1.0, 2.0)),
        ("gamma", 0.7, (2.5, 1.5)),
        ("geometric_probs", 0.0, (1.0,)),
        ("geometric_probs", 3.0, (0.4,)),
        ("dirichlet", [0.0, 0.4, 0.6], ([1.0, 2.0, 3.0],)),
        ("dirichlet", [0.2, 0.3, 0.5], ([1.5, 2.0, 3.0],)),
    ],
)
def test_density_gradients_are_finite_on_the_support_edges_and_match_jax(name, v, params):
    # The double-`where` guards keep an untaken branch's NaN out of the
    # gradient with respect to the parameters (geometric at p = 1, gamma at
    # v = 0 with shape 1, dirichlet on the simplex's edge); where JAX's
    # gradient is finite, the two agree.
    import jax

    probs = name == "geometric_probs"
    dist = "geometric" if probs else name
    ps = [torch.tensor(p, requires_grad=True) for p in params]
    vt = torch.tensor(v)
    if probs:
        lp = torch_lib.geometric.logpdf(vt, probs=ps[0])
        ref_fn = lambda *a: jax_lib.geometric.logpdf(jnp.asarray(v), probs=a[0])  # noqa: E731
    else:
        lp = getattr(torch_lib, dist).logpdf(vt, *ps)
        ref_fn = lambda *a: getattr(jax_lib, dist).logpdf(jnp.asarray(v), *a)  # noqa: E731
    grads = torch.autograd.grad(lp.sum(), ps)
    assert all(torch.isfinite(g).all() for g in grads)
    ref = jax.grad(lambda *a: jnp.sum(ref_fn(*a)), argnums=tuple(range(len(params))))(
        *[jnp.asarray(p, dtype=jnp.float32) for p in params]
    )
    for g, r in zip(grads, ref):
        if np.isfinite(np.asarray(r)).all():
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
