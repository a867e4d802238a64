"""Particle Gibbs with ancestor sampling (PGAS) for state-space models.

Counterpart of `genjax_tpu/inference/particle_gibbs.py`:

- `csmc_sweep`: a conditional bootstrap filter over the latent PATH. One
  particle (index 0) is pinned to the retained trajectory, the others
  propagate freely, and a full path is drawn from the lineage at the end.
  The sweep leaves p(z_{1:T} | y_{1:T}, theta) invariant for any particle
  count. With `ancestor_sampling` (Lindsten, Jordan & Schön 2014) the
  retained particle's parent is drawn anew each step against the
  transition density.
- `ParticleGibbs`: the CSMC path move alternated with a random-walk MH
  move on the parameters, scored by the exact joint density of the
  retained path (`path_log_joint`).

JAX's two `lax.scan`s (the forward sweep, and the walk back through the
lineage) are loops over T here, writing into buffers allocated once; the
draws and indexing stay on the device, so a sweep reads nothing on the
host. Conditional resampling is multinomial (`smc.multinomial_resample`:
i.i.d. ancestors in distribution, from one `logsumexp` of the weights).
"""

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.pytree import Pytree, tree_map
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.inference.particle_filter import BootstrapFilter, _at, _take_rows
from genjax_tpu_torch.inference.pmmh import _broadcast_scales, _select, _walk
from genjax_tpu_torch.inference.smc import multinomial_resample

__all__ = ["ParticleGibbs", "csmc_sweep", "path_log_joint"]


def categorical_draw(rng: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One index per row of `logits` (over its last axis), in proportion to
    `exp(logits)`: Gumbel-max, on the device."""
    gumbel = -torch.log(torch.empty(logits.shape, device=logits.device).exponential_(generator=rng))
    return torch.argmax(logits + gumbel, dim=-1)


def _set_row0(batched: Any, single: Any) -> Any:
    """Row 0 of every leaf of `batched` set to the matching leaf of `single`."""

    def put(b, s):
        s = torch.as_tensor(s, dtype=b.dtype, device=b.device).reshape((1,) + b.shape[1:])
        return torch.cat([s, b[1:]])

    return tree_map(put, batched, single)


def _retained_step(gen_fn, rng, latent_addr: str, obs_addr: str, z_ret, obs, args) -> torch.Tensor:
    """The pinned particle's incremental weight: the model's density of
    (z_ret, obs) given `args` less the latent's own score, i.e. the
    observation term g(obs | z_ret) that the free particles carry too."""
    tr, w_full = gen_fn.importance(rng, ChoiceMap.kw(**{latent_addr: z_ret, obs_addr: obs}), args)
    return w_full - tr.project(rng, Selection.at[latent_addr])


def csmc_sweep(
    rng: torch.Generator,
    filter: BootstrapFilter,
    observations: Any,
    retained_path: Any,
    model_args: tuple = (),
    latent_addr: str = "z",
    ancestor_sampling: bool = True,
):
    """One conditional-SMC sweep; returns a fresh latent path (leaves with
    a leading time axis T) drawn from the particle lineage.

    `retained_path` is the current path (leaves with a leading time axis
    matching `observations`). The filter's models follow the
    `BootstrapFilter` contract (`init_model(*model_args)`,
    `step_model(z_prev, t, *model_args)`), tracing the latent at
    `latent_addr` (their return value) and the observation at
    `filter.obs_addr`."""
    n = filter.n_particles
    obs_addr = filter.obs_addr
    model_args = tuple(model_args)
    T = pytree.tree_leaves(observations)[0].shape[0]

    obs0, ret0 = _at(observations, 0), _at(retained_path, 0)
    init_trs, init_ws = filter.init_model.importance(rng, ChoiceMap.kw(**{obs_addr: obs0}), model_args, n)
    w_ret0 = _retained_step(filter.init_model, rng, latent_addr, obs_addr, ret0, obs0, model_args)
    z = _set_row0(init_trs.get_retval(), ret0)
    lw = _set_row0(init_ws, w_ret0)
    # Every step's states (T, K, ...) and ancestors (T - 1, K), allocated once.
    zs = tree_map(lambda v: v.new_empty((T,) + v.shape), z)
    ancs = torch.empty((max(T - 1, 0), n), dtype=torch.int64, device=lw.device)
    tree_map(lambda buf, v: buf[0].copy_(v), zs, z)
    for t in range(1, T):
        obs_t, ret_t = _at(observations, t), _at(retained_path, t)
        # Conditional multinomial resampling: the free slots draw
        # ancestors from the weights; slot 0's ancestor is the retained
        # lineage (index 0), unless ancestor sampling draws it against the
        # transition-adjusted weights.
        anc = multinomial_resample(rng, lw, n)
        if ancestor_sampling:
            # P(anc_0 = i) ~ w_i f(ret_t | z_i): the model density of
            # (ret_t, obs_t) given parent z_i differs from f by the factor
            # g(obs_t | ret_t) alone, constant in i.
            _, as_scores = filter.step_model.importance(
                rng,
                ChoiceMap.kw(**{latent_addr: ret_t, obs_addr: obs_t}),
                (tree_map(per_particle, z), t, *model_args),
                n,
            )
            anc0 = categorical_draw(rng, lw + as_scores)
        else:
            anc0 = torch.zeros((), dtype=anc.dtype, device=anc.device)
        anc = _set_row0(anc, anc0)
        z_prev = _take_rows(z, anc)
        trs, ws = filter.step_model.importance(
            rng, ChoiceMap.kw(**{obs_addr: obs_t}), (tree_map(per_particle, z_prev), t, *model_args), n
        )
        w_ret = _retained_step(
            filter.step_model, rng, latent_addr, obs_addr, ret_t, obs_t, (_at(z_prev, 0), t, *model_args)
        )
        z = _set_row0(trs.get_retval(), ret_t)
        lw = _set_row0(ws, w_ret)
        tree_map(lambda buf, v: buf[t].copy_(v), zs, z)
        ancs[t - 1] = anc

    # The output path: the last index from the last weights, then back
    # through the lineage (the reverse scan of JAX).
    b = categorical_draw(rng, lw)
    path = tree_map(lambda v: v.new_empty(v.shape[:1] + v.shape[2:]), zs)
    for t in range(T - 1, -1, -1):
        tree_map(lambda out, v: out[t].copy_(v[t].index_select(0, b.reshape(1)).squeeze(0)), path, zs)
        if t:
            b = ancs[t - 1].index_select(0, b.reshape(1)).squeeze(0)
    return path


def path_log_joint(
    filter: BootstrapFilter,
    path: Any,
    observations: Any,
    model_args: tuple = (),
    latent_addr: str = "z",
) -> torch.Tensor:
    """The exact log p(path, observations | model_args): one `assess` of
    the init model plus one of the step model per later step."""
    obs_addr = filter.obs_addr
    model_args = tuple(model_args)
    T = pytree.tree_leaves(observations)[0].shape[0]
    total, _ = filter.init_model.assess(
        ChoiceMap.kw(**{latent_addr: _at(path, 0), obs_addr: _at(observations, 0)}), model_args
    )
    for t in range(1, T):
        s, _ = filter.step_model.assess(
            ChoiceMap.kw(**{latent_addr: _at(path, t), obs_addr: _at(observations, t)}),
            (_at(path, t - 1), t, *model_args),
        )
        total = total + s
    return total


@Pytree.dataclass
class ParticleGibbs(Pytree):
    """Particle Gibbs: a CSMC path move (given the parameters) alternated
    with a random-walk MH parameter move scored by the exact joint density
    of the retained path. Targets p(theta, z_{1:T} | y_{1:T}) exactly for
    any particle count. The filter's models take the parameters as one
    more trailing argument, as for `PMMH`.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.particle_gibbs import ParticleGibbs
    >>> @gx.gen
    ... def init_model(a):
    ...     z = gx.normal(0.0, 1.0) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> @gx.gen
    ... def step_model(z_prev, t, a):
    ...     z = gx.normal(a * z_prev, 0.5) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> pf = gx.BootstrapFilter(step_model, init_model, 64, obs_addr="y")
    >>> pg = ParticleGibbs(pf, log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0), step_scales=0.3)
    >>> ys = torch.tensor([0.3, 1.0, 0.5, -0.2, 0.8])
    >>> theta, path, (thetas, accepts) = pg.run(torch.Generator().manual_seed(0), torch.tensor(0.5), ys, n_sweeps=5)
    >>> thetas.shape, path.shape
    (torch.Size([5]), torch.Size([5]))
    """

    filter: BootstrapFilter
    log_prior: Callable[[Any], Any] = Pytree.static()
    step_scales: Any = 0.25
    latent_addr: str = Pytree.static(default="z")
    ancestor_sampling: bool = Pytree.static(default=True)
    theta_steps: int = Pytree.static(default=1)

    def run(
        self,
        rng: torch.Generator,
        theta0: Any,
        observations: Any,
        n_sweeps: int,
        init_path: Any = None,
        collect: Callable[[Any, Any], Any] | None = None,
    ):
        """Run the chain. Returns `(theta, path, (collected, accepts))`,
        stacked along a leading sweep axis: `collect(theta, path)` after
        each sweep (`theta` by default) and the parameter move's mean
        accept rate. `init_path` defaults to a prior rollout under
        `theta0` (any start is valid; the chain burns in)."""
        scales = _broadcast_scales(self.step_scales, theta0)
        la = self.latent_addr
        theta, path = theta0, init_path
        if path is None:
            path = self._prior_rollout(rng, theta0, observations)
        outs, accs = [], []
        for _ in range(n_sweeps):
            path = csmc_sweep(
                rng, self.filter, observations, path, (theta,), latent_addr=la, ancestor_sampling=self.ancestor_sampling
            )
            lj = path_log_joint(self.filter, path, observations, (theta,), la)
            lp = self.log_prior(theta)
            accepted = []
            for _ in range(self.theta_steps):
                theta_p = _walk(rng, theta, scales)
                lj_p = path_log_joint(self.filter, path, observations, (theta_p,), la)
                lp_p = self.log_prior(theta_p)
                accept = torch.log(torch.rand((), generator=rng, device=rng.device)) < lj_p + lp_p - lj - lp
                theta = _select(accept, theta_p, theta)
                lj, lp = torch.where(accept, lj_p, lj), torch.where(accept, lp_p, lp)
                accepted.append(accept)
            outs.append(theta if collect is None else collect(theta, path))
            accs.append(torch.stack(accepted).float().mean())
        stack = lambda xs: pytree.tree_map(lambda *v: torch.stack(v), *xs)  # noqa: E731
        return theta, path, (stack(outs), torch.stack(accs))

    def _prior_rollout(self, rng: torch.Generator, theta: Any, observations: Any) -> Any:
        """A latent path simulated from the prior under `theta`."""
        T = pytree.tree_leaves(observations)[0].shape[0]
        z = self.filter.init_model.simulate(rng, (theta,)).get_retval()
        zs = [z]
        for t in range(1, T):
            z = self.filter.step_model.simulate(rng, (z, t, theta)).get_retval()
            zs.append(z)
        return pytree.tree_map(lambda *v: torch.stack(v), *zs)
