"""Gradients through the GFI paths that variational objectives
differentiate, against `jax.grad` of the same JAX functions on the CPU.

Each test builds a log weight from numpy-made inputs on both sides and
compares its gradient with respect to the model's arguments and the
constrained values at 1e-5 relative. The paths: a `Scan`'s per-step
buffers (written in place, `Scan`'s `slot.copy_`), a `Vmap` constrained at
an index tensor (the choice map's `index_copy_`), and a particle
collection's LML through the logsumexp wrapper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import genjax_tpu as jgx
import genjax_tpu_torch as tgx

torch.set_num_threads(1)


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


def _leaf(x):
    return torch.tensor(x, dtype=torch.float32, requires_grad=True)


def test_gradient_through_a_scan_generate_like_jax():
    xs = np.array([0.3, -0.7, 1.1, 0.4], dtype=np.float32)

    @tgx.gen
    def tstep(c, a):
        x = tgx.normal(a * c, 0.8) @ "x"
        return x, x

    @jgx.gen
    def jstep(c, a):
        x = jgx.normal(a * c, 0.8) @ "x"
        return x, x

    a, vals = _leaf(0.6), _leaf(xs)
    _, w = tstep.scan(n=4).generate(
        torch.Generator(), tgx.ChoiceMap.kw(x=vals), (torch.tensor(0.5), a.expand(4))
    )
    got = torch.autograd.grad(w, (a, vals))

    def jweight(a, v):
        _, w = jstep.scan(n=4).importance(jax.random.key(0), jgx.ChoiceMap.kw(x=v), (0.5, jnp.broadcast_to(a, (4,))))
        return w

    _close(float(w.detach()), float(jweight(0.6, jnp.asarray(xs))))
    ref = jax.grad(jweight, argnums=(0, 1))(0.6, jnp.asarray(xs))
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r))


def test_gradient_through_a_vmap_constrained_at_an_index_tensor_like_jax():
    rows = np.array([1.5, -0.25], dtype=np.float32)

    @tgx.gen
    def tdatum(w):
        return tgx.normal(w, 1.0) @ "y"

    @jgx.gen
    def jdatum(w):
        return jgx.normal(w, 1.0) @ "y"

    w, vals = _leaf([0.1, 0.2, 0.3, 0.4]), _leaf(rows)
    constraint = tgx.ChoiceMap.entry(vals, torch.tensor([3, 1]), "y")
    _, tw = tdatum.vmap(in_axes=0).generate(torch.Generator(), constraint, (w,))
    got = torch.autograd.grad(tw, (w, vals))

    def jweight(w, v):
        chm = jgx.ChoiceMap.entry(v, jnp.asarray([3, 1]), "y")
        return jdatum.vmap(in_axes=0).importance(jax.random.key(0), chm, (w,))[1]

    args = (jnp.asarray([0.1, 0.2, 0.3, 0.4]), jnp.asarray(rows))
    _close(float(tw.detach()), float(jweight(*args)))
    for g, r in zip(got, jax.grad(jweight, argnums=(0, 1))(*args)):
        _close(g.numpy(), np.asarray(r))


def test_gradient_through_a_collection_lml_like_jax():
    # The LML estimate of K = 64 particles held at the same numpy values on
    # both sides; the gradient with respect to the model's mean passes
    # through the batched importance weights and the logsumexp.
    xs = np.random.default_rng(0).normal(size=64).astype(np.float32)

    @tgx.gen
    def tmodel(m):
        x = tgx.normal(m, 1.0) @ "x"
        _ = tgx.normal(x, 0.5) @ "y"

    @jgx.gen
    def jmodel(m):
        x = jgx.normal(m, 1.0) @ "x"
        _ = jgx.normal(x, 0.5) @ "y"

    m = _leaf(0.2)
    target = tgx.Target(tmodel, (m,), tgx.ChoiceMap.kw(y=1.0))
    trs, w = target.importance(torch.Generator(), tgx.ChoiceMap.kw(x=tgx.per_particle(torch.from_numpy(xs))), n=64)
    lml = tgx.ParticleCollection(trs, w).get_log_marginal_likelihood_estimate()
    (got,) = torch.autograd.grad(lml, m)

    def jlml(m):
        t = jgx.Target(jmodel, (m,), jgx.ChoiceMap.kw(y=1.0))
        ws = jax.vmap(lambda x: t.importance(jax.random.key(0), jgx.ChoiceMap.kw(x=x))[1])(jnp.asarray(xs))
        return jax.scipy.special.logsumexp(ws) - jnp.log(64.0)

    _close(float(lml.detach()), float(jlml(0.2)))
    _close(float(got), float(jax.grad(jlml)(0.2)))
