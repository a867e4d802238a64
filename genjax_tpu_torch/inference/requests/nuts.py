"""NUTS: the No-U-Turn sampler as an edit request.

Counterpart of `genjax_tpu/inference/requests/nuts.py`: `NUTSInfo`,
`nuts_kernel`, `NUTS` and `nuts_warmup`. Multinomial NUTS with the
generalized (momentum-sum) U-turn criterion (Hoffman & Gelman 2014;
Betancourt 2017): per draw the trajectory doubles away from the start in
random directions until a sub-trajectory turns or diverges, and the new
state is a multinomial draw from the visited states weighted by
`exp(-energy)`. The weight is 0, so the move composes with `mh`,
`mh_chain` and `run_chains` (every proposal is accepted).

The formulation is JAX's iterative one with a fixed schedule, over a
batch of C chains at once:

- Doubling level `d` runs `2**d` leapfrog steps, so a draw always costs
  `2**max_depth - 1` gradient passes (plus one at the start); a chain
  that has turned or diverged is carried along under a per-chain mask.
  Nothing is read on the host: there is no early exit when every chain is
  done, as there is none in JAX.
- Within a subtree the U-turn checks of the recursive algorithm's binary
  nodes come from a checkpoint stack of at most `max_depth` slots: leaf `i`
  opens nodes when it is even (slot `popcount(i >> 1)`) and closes the
  nodes whose span ends at it when it is odd (the `trailing-ones(i)`
  innermost slots). These indices are Python ints, so each leaf is
  straight-line code over `(C, dim)` tensors.
- The selected values are flattened into one `(C, dim)` tensor: each
  floating-point leaf's event axes behind the chain axis, concatenated.
- All of a draw's randomness is drawn up front (the momenta, each level's
  direction, each leaf's uniform and each merge's uniform) and handed to a
  deterministic core, `nuts_draw`.
"""

from typing import Any

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.choice_map import Selection
from genjax_tpu_torch.core.concepts import Argdiffs, EditRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gather import batched_mask
from genjax_tpu_torch.core.gfi import Trace, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray, plain
from genjax_tpu_torch.inference.requests.hmc import _is_float, _mass_leaves, make_selection_grad_fn

__all__ = ["NUTS", "NUTSInfo", "nuts_draw", "nuts_kernel", "nuts_warmup"]

_MAX_DELTA_ENERGY = 1000.0  # Stan's divergence threshold


@Pytree.dataclass
class NUTSInfo(Pytree):
    """Per-draw diagnostics, one per chain: `accept_stat` is the mean
    Metropolis acceptance statistic over the visited states (the
    dual-averaging signal), `depth` the number of completed doublings,
    `diverged` whether the trajectory crossed the energy-error
    threshold."""

    accept_stat: FloatArray
    depth: Any
    diverged: Any


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _trailing_ones(x: int) -> int:
    t = 0
    while x & 1:
        t += 1
        x >>= 1
    return t


def _level_schedule(d: int) -> list[tuple[bool, int, list[int]]]:
    """Per leaf of a depth-`d` subtree: (stores a checkpoint, its slot,
    the slots whose binary nodes close at it)."""
    out = []
    for i in range(1 << d):
        slot = _popcount(i >> 1)
        closes = list(range(slot - _trailing_ones(i) + 1, slot + 1)) if i % 2 == 1 else []
        out.append((i % 2 == 0, slot, closes))
    return out


def _on(x, like: torch.Tensor) -> torch.Tensor:
    """A number or tensor as a tensor on `like`'s device, in its dtype; a
    number by a fill on the device (a copy from the host would wait for
    the stream)."""
    if isinstance(x, torch.Tensor):
        return plain(x).to(device=like.device, dtype=like.dtype)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def _flat_problem(selection: Selection, tr: Trace[Any], argdiffs, inv_mass):
    """The selected floating-point leaves as one `(C, dim)` tensor (C = 1
    for a trace without a chain axis); returns `(q0, im, logp_grad,
    rebuild)`, `im` the `(dim,)` diagonal of M^-1."""
    values = tr.get_choices().filter(selection)
    leaves, spec, bits = batched_mask(values)
    n = tr.particle_count()
    chains = 1 if n is None else n
    grad_idx = [i for i, v in enumerate(leaves) if _is_float(v)]
    if not grad_idx:
        raise ValueError("NUTS: the selection matched no differentiable addresses.")
    if n is not None and not all(bits[i] for i in grad_idx):
        raise ValueError("NUTS: a selected value is shared by every chain (it carries no chain axis)")
    shapes = [leaves[i].shape[1:] if n is not None else leaves[i].shape for i in grad_idx]
    sizes = [s.numel() for s in shapes]
    q0 = torch.cat([plain(leaves[i]).reshape(chains, -1) for i in grad_idx], dim=1)
    masses = [_on(m, q0) for m in _mass_leaves(inv_mass, leaves)]
    im = torch.cat([torch.broadcast_to(masses[i], s).reshape(-1) for i, s in zip(grad_idx, shapes)])
    grad_fn = make_selection_grad_fn(selection, tr, argdiffs)

    def rebuild(q: torch.Tensor):
        out = list(leaves)
        for i, s, part in zip(grad_idx, shapes, torch.split(q, sizes, dim=1)):
            out[i] = part.reshape(s) if n is None else part.reshape((n, *s))
        return pytree.tree_unflatten(out, spec)

    def logp_grad(q: torch.Tensor):
        score, g = grad_fn(rebuild(q))
        g = pytree.tree_leaves(g)
        return score.reshape(chains), torch.cat([g[i].reshape(chains, -1) for i in grad_idx], dim=1)

    return q0, im, logp_grad, rebuild


def nuts_randomness(rng: torch.Generator, q0: torch.Tensor, im: torch.Tensor, max_depth: int):
    """One draw's randomness for C chains, drawn up front: the momenta
    `p0 ~ N(0, M)` `(C, dim)`, each level's direction `(max_depth, C)`,
    each leaf's uniform `(2**max_depth - 1, C)` (level `d`'s leaves at
    rows `2**d - 1` to `2**(d+1) - 2`) and each merge's uniform
    `(max_depth, C)`."""
    chains = q0.shape[0]
    p0 = torch.randn(q0.shape, generator=rng, device=q0.device) / torch.sqrt(im)
    u = torch.rand((2 * max_depth + (1 << max_depth) - 1, chains), generator=rng, device=q0.device)
    return p0, u[:max_depth] < 0.5, u[2 * max_depth :], u[max_depth : 2 * max_depth]


def nuts_draw(q0, im, logp_grad, eps, max_depth: int, p0, go_right, leaf_u, merge_u):
    """One NUTS trajectory for each of C chains, from given randomness
    (`nuts_randomness`'s four tensors); draws nothing. `q0` is `(C, dim)`,
    `logp_grad(q)` returns the `(C,)` log densities and their `(C, dim)`
    gradients. Returns `(q_new, NUTSInfo)`."""
    chains = q0.shape[0]
    dev = q0.device

    def kinetic(p):
        return 0.5 * (im * torch.square(p)).sum(-1)

    def leapfrog(q, p, g, eps_s):
        p = p + 0.5 * eps_s * g
        q = q + eps_s * im * p
        logp, g = logp_grad(q)
        p = p + 0.5 * eps_s * g
        return q, p, g, -logp + kinetic(p)

    eps = _on(eps, q0)
    false = torch.zeros(chains, dtype=torch.bool, device=dev)
    zero = torch.zeros(chains, dtype=q0.dtype, device=dev)
    neg_inf = torch.full((chains,), -torch.inf, dtype=q0.dtype, device=dev)
    with torch.no_grad():
        logp0, g0 = logp_grad(q0)
        h0 = -logp0 + kinetic(p0)
        left = right = (q0, p0, g0)
        rho, prop, log_w = p0, q0, zero  # the root leaf has weight exp(-(h0 - h0))
        done, diverged = false, false
        depth = torch.zeros(chains, dtype=torch.int32, device=dev)
        acc_sum, n_acc = zero, zero

        for d in range(max_depth):
            right_d = go_right[d]
            eps_s = torch.where(right_d, eps, -eps)[:, None]
            q, p, g = (torch.where(right_d[:, None], r, l) for r, l in zip(right, left))
            sub_rho = torch.zeros_like(q0)
            sub_log_w, sub_prop = neg_inf, q
            ckpt_p, ckpt_rho = {}, {}
            failed, sub_div = false, false
            sub_acc, sub_n = zero, zero
            for i, (store, slot, closes) in enumerate(_level_schedule(d)):
                alive = ~failed
                q, p, g, h = leapfrog(q, p, g, eps_s)
                delta = h - h0
                div = ~(delta < _MAX_DELTA_ENERGY)  # NaN-safe: NaN diverges
                log_w_new = torch.logaddexp(sub_log_w, -delta)
                ok = alive & ~div
                # Progressive multinomial proposal within the subtree.
                take = ok & (torch.log(leaf_u[(1 << d) - 1 + i]) < -delta - log_w_new)
                rho_before = sub_rho
                if store:  # even leaves open binary nodes
                    ckpt_p[slot], ckpt_rho[slot] = p, rho_before
                rho_cum = rho_before + p
                # Close the nodes ending at this (odd) leaf: a span turns if
                # its momentum sum points against the velocity at either end.
                turned = false
                for s in closes:
                    seg = rho_cum - ckpt_rho[s]
                    turned = turned | ((seg * (im * ckpt_p[s])).sum(-1) < 0.0) | ((seg * (im * p)).sum(-1) < 0.0)
                acc = torch.nan_to_num(torch.exp(torch.minimum(-delta, torch.zeros_like(delta))), nan=0.0)
                sub_rho = torch.where(ok[:, None], rho_cum, rho_before)
                sub_log_w = torch.where(ok, log_w_new, sub_log_w)
                sub_prop = torch.where(take[:, None], q, sub_prop)
                failed = failed | div | (ok & turned)
                sub_div = sub_div | (alive & div)
                sub_acc = sub_acc + torch.where(alive, acc, 0.0)
                sub_n = sub_n + alive.to(q0.dtype)

            active = ~done
            sub_ok = ~failed
            merge = active & sub_ok
            # Biased progressive merge across doublings: the new subtree's
            # proposal wins in proportion to its total weight.
            take_sub = merge & (torch.log(merge_u[d]) < sub_log_w - log_w)
            prop = torch.where(take_sub[:, None], sub_prop, prop)
            log_w = torch.where(merge, torch.logaddexp(log_w, sub_log_w), log_w)
            rho = torch.where(merge[:, None], rho + sub_rho, rho)
            endpoint = (q, p, g)
            to_right, to_left = (merge & right_d)[:, None], (merge & ~right_d)[:, None]
            right = tuple(torch.where(to_right, new, old) for new, old in zip(endpoint, right))
            left = tuple(torch.where(to_left, new, old) for new, old in zip(endpoint, left))
            turn_tree = ((rho * (im * left[1])).sum(-1) < 0.0) | ((rho * (im * right[1])).sum(-1) < 0.0)
            done = done | ~sub_ok | (merge & turn_tree)
            diverged = diverged | (active & sub_div)
            depth = depth + merge.to(torch.int32)
            acc_sum = acc_sum + torch.where(active, sub_acc, 0.0)
            n_acc = n_acc + torch.where(active, sub_n, 0.0)

    info = NUTSInfo(accept_stat=acc_sum / torch.clamp(n_acc, min=1.0), depth=depth, diverged=diverged)
    return prop, info


def _single(info: NUTSInfo) -> NUTSInfo:
    return NUTSInfo(info.accept_stat[0], info.depth[0], info.diverged[0])


def nuts_kernel(
    rng: torch.Generator,
    tr: Trace[Any],
    selection: Selection,
    eps,
    max_depth: int = 8,
    inv_mass=None,
    argdiffs=None,
) -> tuple[Trace[Any], NUTSInfo]:
    """One NUTS draw on every chain of `tr`'s selected addresses; returns
    the new trace and the per-chain diagnostics (scalars for a trace
    without a chain axis).

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.requests.nuts import nuts_kernel
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(y=1.0), (), n=8)
    >>> new, info = nuts_kernel(rng, tr, gx.Selection.at["mu"], 0.5, max_depth=4)
    >>> info.depth.shape, bool(((info.accept_stat >= 0) & (info.accept_stat <= 1)).all())
    (torch.Size([8]), True)
    """
    if argdiffs is None:
        argdiffs = Diff.no_change(tr.get_args())
    q0, im, logp_grad, rebuild = _flat_problem(selection, tr, argdiffs, inv_mass)
    p0, go_right, leaf_u, merge_u = nuts_randomness(rng, q0, im, max_depth)
    q_new, info = nuts_draw(q0, im, logp_grad, eps, max_depth, p0, go_right, leaf_u, merge_u)
    new_tr, _, _, _ = Update(rebuild(q_new)).edit(rng, tr, argdiffs)
    return new_tr, (_single(info) if tr.particle_count() is None else info)


@Pytree.dataclass
class NUTS(EditRequest):
    """No-U-Turn move over the selected addresses. Always a valid draw
    from the NUTS kernel (weight 0, like `EllipticalSlice`), so it
    composes with `mh`, `mh_chain` and `run_chains`.

    `max_depth` caps the doublings; each draw costs `2**max_depth - 1`
    gradient passes over the chain batch. Tune `eps` and `inv_mass` with
    `nuts_warmup`.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.requests import NUTS
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(y=1.0), (), n=4)
    >>> new_tr, accepted = gx.mh(rng, tr, NUTS(gx.Selection.at["mu"], 0.5, max_depth=5))
    >>> bool(accepted.all())  # weight 0: every proposal is the new state
    True
    """

    selection: Selection
    eps: FloatArray
    max_depth: int = Pytree.static(default=8)
    inv_mass: Any = None

    def edit(self, rng: torch.Generator, tr: Trace[Any], argdiffs: Argdiffs):
        if not Diff.static_check_no_change(argdiffs):
            raise ValueError("NUTS moves a trace under its own arguments")
        new_tr, _ = nuts_kernel(rng, tr, self.selection, self.eps, self.max_depth, self.inv_mass, argdiffs)
        n = tr.particle_count()
        weight = torch.zeros(() if n is None else (n,), device=new_tr.get_score().device)
        return (
            new_tr,
            weight,
            Diff.unknown_change(new_tr.get_retval()),
            NUTS(self.selection, self.eps, self.max_depth, self.inv_mass),
        )


def nuts_step(selection: Selection, max_depth: int):
    """One NUTS draw on a batch with its accept statistic, for
    `adaptation.adapt_blocks`."""

    def step(rng, traces, eps, inv_mass):
        traces, info = nuts_kernel(rng, traces, selection, eps, max_depth, inv_mass)
        return traces, info.accept_stat

    return step


def nuts_warmup(
    rng: torch.Generator,
    traces: Trace[Any],
    selection: Selection,
    n_steps: int = 150,
    *,
    max_depth: int = 6,
    eps0: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    n_chains: int | None = None,
    mesh=None,
    axis: str = "chains",
):
    """Warm up a chain batch for NUTS: dual-average a shared step size on
    the cross-chain mean accept statistic and, with `adapt_mass`, estimate
    a shared diagonal mass matrix, with the three-phase schedule of
    `adaptation.warmup_chains`. Returns `(warmed_traces, WarmupResult)`;
    sample with `NUTS(sel, result.eps, max_depth, result.inv_mass)`. No
    step reads the device on the host.

    With `mesh`, `traces` are this rank's chains of a batch whose chain
    axis spans the mesh's `axis`, as `warmup_chains` takes them: the
    rank's draws come from `fork(rng, n)[rank]`, and the mean accept
    statistic and the mass matrix are global."""
    from genjax_tpu_torch.inference.adaptation import adapt_blocks, chain_statistics, chain_streams

    (traces,), result = adapt_blocks(
        chain_streams(rng, mesh, axis), [traces], chain_statistics(traces, n_chains, mesh, axis), selection,
        n_steps, nuts_step(selection, max_depth), eps0, target_accept, adapt_mass,
    )
    return traces, result
