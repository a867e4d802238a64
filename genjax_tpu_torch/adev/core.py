"""ADEV: automatic differentiation of expected values, on PyTorch.

Counterpart of `genjax_tpu/adev/core.py` (`ADEVPrimitive`,
`TailCallADEVPrimitive`, `TailCallBatchedADEVPrimitive`,
`sample_primitive`, `Dual`, `forward_mode`, `ADEVProgram`, `Expectation`,
`expectation`), after Lew, Huot, Staton & Mansinghka (2023), "ADEV: Sound
Automatic Differentiation of Expected Values of Probabilistic Programs".

How it runs without a jaxpr
---------------------------
The JAX package stages the loss into a jaxpr and walks it in
continuation-passing style, cutting the continuation at each sample
equation. Here the loss is eager Python, so there is nothing to cut:

* **Estimates are tensors whose autograd gradient is the tangent.** A
  strategy returns a tensor whose value is the estimate and whose gradient
  with respect to the parameters is an unbiased gradient estimate (the
  "magic box": REINFORCE adds `stopgrad(L) * (log p - stopgrad(log p))`).
  `grad_estimate` is then one `torch.autograd.grad` over one execution,
  whatever the number of parameters; `jvp_estimate` is `<grad, tangent>`.
* **A handler stack replaces the jaxpr interpreter.** `expectation` runs
  the loss with an ADEV handler installed (as `lang/interop.py` does for
  the GFI); each sample site (`sample_primitive`, reached through an
  `adev_distribution`'s sampler deep inside `simulate`) asks the innermost
  handler. `genjax_tpu/core/primitives.py` (staged primitives) and
  `core/environment.py` (the jaxpr variable store) exist only to stage and
  interpret jaxprs; they have no counterpart.
* **Continuations by re-execution.** A strategy that runs its continuation
  once (reparameterization, REINFORCE, `add_cost`) returns its value to the
  program and leaves a `finish` for the program's result, applied when the
  execution ends (the later sites' first, as the continuations nest). A
  strategy that runs it several times (enumeration, MVD) calls
  `kdual(v)`: the loss runs again from the start, the earlier sites
  replaying their values, this site forced to `v`, the later sites drawing
  from their own seeds, so every call sees the same downstream randomness
  (JAX's continuation calls share a key). The result of a re-execution is
  the estimate of the whole program; the strategy combines them and the
  execution that reached the site ends there with the combination. (The
  earlier sites' `finish`es act inside each re-execution; they are affine
  in the result and the combinations' weights sum to one, so this equals
  applying them to the combination.)

Randomness: each site draws from its own generator, seeded by (the walk's
seed, the site's ordinal in the execution, and the branch of each
enumeration above it that asked for a stream of its own). The walk's seed
is a hash of the state of the generator given to `estimate` /
`grad_estimate`, which is then advanced; that generator is the program's
own, and its state is restored at the start of every execution. A sample
site outside any expectation draws from the generator it is given.
"""

import hashlib
import threading
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import DEFAULT_DTYPE, on_device

_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def _digest(*parts) -> int:
    """A 63-bit seed from hashable parts."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def _state_seed(rng: torch.Generator) -> int:
    """A seed from `rng`'s state, read on the host (no device read), then
    `rng` advanced by one draw so that the next call gives another."""
    h = hashlib.blake2b(rng.get_state().numpy().tobytes(), digest_size=8).digest()
    torch.empty((), device=rng.device).uniform_(generator=rng)
    return int.from_bytes(h, "little") >> 1


def fork(rng: torch.Generator, k: int) -> list[torch.Generator]:
    """`k` new generators on `rng`'s device, seeded from `rng`'s state
    (read on the host) and their index, then `rng` advanced: the port's
    `jax.random.split`. Inside an expectation, where `rng` is the program's
    generator, every execution forks the same `k` streams.

    >>> import torch
    >>> from genjax_tpu_torch.adev.core import fork
    >>> a, b = fork(torch.Generator().manual_seed(0), 2)
    >>> a2, _ = fork(torch.Generator().manual_seed(0), 2)
    >>> bool(torch.rand(1, generator=a) == torch.rand(1, generator=a2)), a.initial_seed() != b.initial_seed()
    (True, True)
    """
    seed = _state_seed(rng)
    gens = []
    for i in range(k):
        g = torch.Generator(device=rng.device)
        g.manual_seed(_digest(seed, i))
        gens.append(g)
    return gens


class ADEVPrimitive(Pytree):
    """A sampler with a gradient-estimation strategy.

    A strategy is given the site's generator, its arguments (tensors whose
    autograd graph carries their tangents) and the batch `n` (None, or the
    batch axes the site draws for: a particle count, or the stack of a
    `Vmap`). It either runs the rest of the program once, `continue_with`
    giving `(value, finish)` (`finish` maps the estimate of the rest of the
    program to this site's, or is None for the identity), or returns None
    there and implements `jvp_estimate` over the continuations."""

    def sample(self, rng: torch.Generator, *args, n=None) -> Any:
        raise NotImplementedError

    def continue_with(self, rng: torch.Generator, args: tuple, n=None):
        return None

    def jvp_estimate(self, rng: torch.Generator, args: tuple, konts, n=None) -> torch.Tensor:
        """The estimate of the whole expectation, given `konts = (kpure,
        kdual)`: `kdual(v, stream=0)` is the estimate of the program with
        this site's value `v` (a tensor whose gradient is the tangent),
        `kpure(v, stream=0)` its value alone. A nonzero `stream` gives the
        later sites randomness of their own for that call."""
        once = self.continue_with(rng, args, n)
        if once is None:
            raise NotImplementedError(f"{type(self).__name__} has no strategy")
        v, finish = once
        out = konts[1](v)
        return out if finish is None else finish(out)

    def get_batched_prim(self, n) -> "ADEVPrimitive":
        raise NotImplementedError(
            f"{type(self).__name__} does not support a batch of sites: provide a batched strategy via get_batched_prim."
        )

    def __call__(self, *args, n=None):
        return sample_primitive(self, *args, n=n)


class TailCallADEVPrimitive(ADEVPrimitive):
    """Strategies that run the rest of the program once with a value whose
    gradient is the pathwise derivative (reparameterization): only
    `before_tail_call` is needed, by default the sampler itself, through
    which autograd differentiates."""

    def before_tail_call(self, rng: torch.Generator, args: tuple, n=None) -> Any:
        return self.sample(rng, *args, n=n)

    def continue_with(self, rng, args, n=None):
        return self.before_tail_call(rng, args, n), None

    def get_batched_prim(self, n) -> "ADEVPrimitive":
        return TailCallBatchedADEVPrimitive(self, n)


@Pytree.dataclass
class TailCallBatchedADEVPrimitive(TailCallADEVPrimitive):
    """A tail-call strategy lifted over the batch axes `n`: the sampler
    draws for every lane at once (its parameters' batch marks say which of
    them carry lanes), so the lift only fixes `n`."""

    original_prim: TailCallADEVPrimitive
    n: Any = Pytree.static()

    def sample(self, rng, *args, n=None):
        return self.original_prim.sample(rng, *args, n=self.n)

    def before_tail_call(self, rng, args, n=None):
        return self.original_prim.before_tail_call(rng, args, self.n)


def sample_primitive(adev_prim: ADEVPrimitive, *args, rng: torch.Generator | None = None, n=None) -> Any:
    """An ADEV sample site. Under an expectation the innermost ADEV handler
    runs the primitive's strategy; elsewhere this draws from `rng` (a
    generator seeded 0 on the arguments' device where none is given, as
    JAX's default key is `key(0)`)."""
    stack = _stack()
    if stack:
        return stack[-1].site(adev_prim, args, n)
    if rng is None:
        device = next((a.device for a in pytree.tree_leaves(args) if isinstance(a, torch.Tensor)), "cpu")
        rng = torch.Generator(device=device).manual_seed(0)
    return adev_prim.sample(rng, *args, n=n)


########
# Dual #
########


def _is_dual(x) -> bool:
    return isinstance(x, Dual)


@Pytree.dataclass
class Dual(Pytree):
    """A primal value with its tangent."""

    primal: Any
    tangent: Any

    @staticmethod
    def tree_pure(v):
        return pytree.tree_map(
            lambda x: x if _is_dual(x) else Dual(x, torch.zeros_like(torch.as_tensor(x))), v, is_leaf=_is_dual
        )

    @staticmethod
    def dual_tree(primals, tangents):
        return pytree.tree_map(lambda p, t: Dual(p, t), primals, tangents)

    @staticmethod
    def tree_primal(v):
        return pytree.tree_map(lambda x: x.primal if _is_dual(x) else x, v, is_leaf=_is_dual)

    @staticmethod
    def tree_tangent(v):
        return pytree.tree_map(lambda x: x.tangent if _is_dual(x) else x, v, is_leaf=_is_dual)

    @staticmethod
    def tree_leaves(v):
        return pytree.tree_leaves(Dual.tree_pure(v), is_leaf=_is_dual)

    @staticmethod
    def tree_unzip(v):
        primals = pytree.tree_leaves(Dual.tree_primal(v))
        tangents = pytree.tree_leaves(Dual.tree_tangent(v))
        return tuple(primals), tuple(tangents)


##############################
# Executions under the walk #
##############################


class _Resolved(BaseException):
    """Raised by a site whose strategy ran the rest of the program itself:
    the execution ends with `value`. (A BaseException, so that no
    `except Exception` in a program stops it.)"""

    def __init__(self, value):
        super().__init__()
        self.value = value


class _Execution:
    """One run of the loss under the transform: `forced` holds the values
    of the multi-call sites above this run (and of the site it continues),
    by ordinal; `streams` the `(ordinal, stream)` of the branches that gave
    their later sites randomness of their own."""

    def __init__(self, walk: "_Walk", forced: dict, streams: tuple):
        self.walk = walk
        self.forced = forced
        self.streams = streams
        self.ordinal = 0
        self.finishers: list = []

    def site(self, prim: ADEVPrimitive, args: tuple, n) -> Any:
        k = self.ordinal
        self.ordinal += 1
        if k in self.forced:
            return self.forced[k]
        if n is not None:
            prim = prim.get_batched_prim(n)
        rng = self.walk.site_generator(k, self.streams)
        once = prim.continue_with(rng, args, n)
        if once is not None:
            v, finish = once
            if finish is not None:
                self.finishers.append(finish)
            return v

        def kdual(v, stream: int = 0):
            streams = self.streams + ((k, stream),) if stream else self.streams
            return self.walk.execute({**self.forced, k: v}, streams)

        def kpure(v, stream: int = 0):
            with torch.no_grad():
                return kdual(v, stream).detach()

        raise _Resolved(prim.jvp_estimate(rng, args, (kpure, kdual), n))


class _Walk:
    """The executions of one estimate of `source(*args)`."""

    def __init__(self, source: Callable, args: tuple, rng: torch.Generator):
        self.source = source
        self.args = args
        self.rng = rng
        self.seed = _state_seed(rng)
        self.state = rng.get_state()

    def site_generator(self, k: int, streams: tuple) -> torch.Generator:
        g = torch.Generator(device=self.rng.device)
        g.manual_seed(_digest(self.seed, k, tuple(s for s in streams if s[0] < k)))
        return g

    def execute(self, forced: dict, streams: tuple) -> torch.Tensor:
        self.rng.set_state(self.state)
        run = _Execution(self, forced, streams)
        stack = _stack()
        stack.append(run)
        try:
            out = self.source(*self.args)
        except _Resolved as done:
            return done.value
        finally:
            stack.pop()
        out = on_device(out, self.rng.device, DEFAULT_DTYPE)
        for finish in reversed(run.finishers):
            out = finish(out)
        return out


################
# Expectation  #
################


def _leaf(x, device) -> torch.Tensor:
    """An argument as a float32 leaf tensor that records its gradient."""
    t = on_device(x, device)
    if not t.is_floating_point():
        raise TypeError(f"ADEV differentiates real arguments only; got dtype {t.dtype}")
    return t.detach().to(DEFAULT_DTYPE).requires_grad_()


@Pytree.dataclass
class ADEVProgram(Pytree):
    source: Callable[..., Any] = Pytree.static()

    def run(self, rng: torch.Generator, args) -> torch.Tensor:
        """The estimate of one walk: the loss called with the leaves of
        `args` (flattened, as JAX's transform passes them)."""
        return _Walk(self.source, tuple(pytree.tree_leaves(args)), rng).execute({}, ())

    def jvp_estimate(self, rng: torch.Generator, dual_tree, dual_kont) -> "Dual":
        return dual_kont(Expectation(self).jvp_estimate(rng, dual_tree))


def _grads(out: torch.Tensor, leaves: list) -> list:
    if not out.requires_grad:
        return [torch.zeros_like(x) for x in leaves]
    gs = torch.autograd.grad(out, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, gs)]


@Pytree.dataclass
class Expectation(Pytree):
    """An expectation-valued objective `E[f(args, randomness)]` with
    unbiased gradient estimates from the strategies at its sample sites."""

    prog: ADEVProgram

    def estimate(self, rng: torch.Generator, args):
        """The objective's value, one walk."""
        leaves, _ = pytree.tree_flatten(args)
        with torch.no_grad():
            return self.prog.run(rng, [on_device(x, rng.device) for x in leaves]).detach()

    def value_and_grad_estimate(self, rng: torch.Generator, primals):
        """(value, gradient) from one walk, the gradient in the structure
        of `primals`."""
        leaves, spec = pytree.tree_flatten(primals)
        xs = [_leaf(x, rng.device) for x in leaves]
        out = self.prog.run(rng, xs)
        return out.detach(), pytree.tree_unflatten(_grads(out, xs), spec)

    def grad_estimate(self, rng: torch.Generator, primals):
        """An unbiased estimate of the gradient of the expectation with
        respect to `primals`, from one walk and one backward pass."""
        return self.value_and_grad_estimate(rng, primals)[1]

    def jvp_estimate(self, rng: torch.Generator, dual_tree) -> Dual:
        """`Dual(value, <gradient, tangent>)`: the scalar objective's
        forward-mode derivative along the duals' tangents."""
        primals, tangents = Dual.tree_unzip(dual_tree)
        value, grads = self.value_and_grad_estimate(rng, list(primals))
        jvp = torch.zeros((), device=rng.device)
        for g, t in zip(grads, tangents):
            jvp = jvp + (g * torch.as_tensor(t, device=g.device)).sum()
        return Dual(value, jvp)


def forward_mode(f: Callable[..., Any], kont=lambda v: v):
    """`forward_mode(f)(rng, dual_tree) -> kont(Dual)`: the forward-mode
    estimate of the expectation of `f` (a scalar) along the tangents."""

    def _dual(rng: torch.Generator, dual_tree):
        return kont(Expectation(ADEVProgram(f)).jvp_estimate(rng, dual_tree))

    return _dual


def expectation(source: Callable[..., Any]) -> Expectation:
    """Decorator: a stochastic program as an expectation-valued objective
    with ADEV gradient estimates.

    >>> import torch
    >>> from genjax_tpu_torch.adev import expectation, flip_enum
    >>> @expectation
    ... def loss(p):
    ...     b = flip_enum(p)
    ...     return torch.where(b, 1.0, 0.0)
    >>> (grad,) = loss.grad_estimate(torch.Generator().manual_seed(0), (0.3,))
    >>> print(round(float(grad), 4))  # E = p, exactly differentiated
    1.0
    """
    return Expectation(ADEVProgram(source))


__all__ = [
    "ADEVPrimitive",
    "ADEVProgram",
    "Dual",
    "Expectation",
    "TailCallADEVPrimitive",
    "TailCallBatchedADEVPrimitive",
    "expectation",
    "fork",
    "forward_mode",
    "sample_primitive",
]
