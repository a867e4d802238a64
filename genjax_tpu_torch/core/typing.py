"""Type aliases, the default dtype, device helpers, and the batch-axis
record (`PerParticle` and the deeper marks).

Counterpart of `genjax_tpu/core/typing.py`. float32 is the default real
type, as in JAX without x64. Python numbers stay Python numbers where a
torch operation accepts them (no host-to-device copy per site); values
that must be tensors are made on an explicit device.
"""

import sys
from collections.abc import Callable, Generator, Iterable, Sequence  # noqa: F401 (re-export)
from types import EllipsisType  # noqa: F401 (re-export)
from typing import Annotated, Any, Final, Generic, ParamSpec, TypeAlias, TypeVar  # noqa: F401 (re-export)

if sys.version_info >= (3, 11):
    from typing import Self  # noqa: F401 (re-export)
else:  # pragma: no cover
    Self = TypeVar("Self")

import numpy as np
import torch
from torch._C import DisableTorchFunctionSubclass

# JAX's aliases: an array is a tensor, a key a generator.
Array: TypeAlias = torch.Tensor
ArrayLike: TypeAlias = torch.Tensor | np.ndarray | int | float | bool
PRNGKey: TypeAlias = torch.Generator
IntArray: TypeAlias = int | torch.Tensor
FloatArray: TypeAlias = float | torch.Tensor
BoolArray: TypeAlias = bool | torch.Tensor
#: A Python bool (known when the program runs) or a boolean tensor.
Flag: TypeAlias = bool | torch.Tensor
ScalarFlag: TypeAlias = bool | torch.Tensor
InAxes: TypeAlias = int | None | Sequence[Any]

R = TypeVar("R")

DEFAULT_DTYPE = torch.float32


def device_of(*xs: Any, default: torch.device | str | None = None) -> torch.device:
    """The device of the first tensor among `xs`, else `default` (else CPU)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device(default if default is not None else "cpu")


def as_value(v: Any, device: torch.device | str) -> torch.Tensor:
    """A constrained or assessed value as a tensor: tensors pass through
    untouched, Python bools become bool tensors and other Python numbers
    float32 tensors on `device`, each made by a fill on the device (a
    copy from the host would synchronise with a CUDA device)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=torch.bool if isinstance(v, bool) else DEFAULT_DTYPE, device=device)


def on_device(x: Any, device: torch.device | str, dtype: torch.dtype | None = None) -> torch.Tensor:
    """`x` as a tensor on `device` (of `dtype`, if given): a tensor is
    moved, a Python number filled on the device (a copy from the host
    would wait for a CUDA device), anything else (a numpy array) copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype) if dtype is not None else x.to(device)
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=dtype or (DEFAULT_DTYPE if isinstance(x, float) else None), device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def as_generator(rng: torch.Generator | int, device: torch.device | str) -> torch.Generator:
    """`rng` itself (which must live on `device`), or a generator on
    `device` seeded with the int `rng`."""
    device = torch.device(device)
    if isinstance(rng, int):
        return torch.Generator(device=device).manual_seed(rng)
    if rng.device.type != device.type:
        raise ValueError(f"the generator lives on {rng.device}, the run on {device}: pass device={str(rng.device)!r}")
    return rng


def host_scalar(v: Any) -> float | None:
    """The value of `v` as a Python float when the host can read it for
    free: a Python number, or a 0-d CPU tensor. None otherwise, and never
    a read of a CUDA tensor (that would synchronise with the device)."""
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, torch.Tensor) and v.device.type == "cpu" and v.dim() == 0:
        if v.dtype == torch.bool:
            return None
        return float(v)
    return None


class PerParticle(torch.Tensor):
    """A tensor whose leading axis is the particle (or chain) axis.

    The port never guesses from a size whether a value carries that axis:
    it records it. Inside a body run with a particle count `n` by
    `simulate` or `generate`, every value drawn with `n` is handed to the
    body as a `PerParticle`, and PyTorch keeps the type on everything
    computed from it, so a site knows which of its parameters are per
    particle. Traces store plain tensors and keep the record beside them
    (`Trace.batched_leaves`). A caller marks a per-particle argument or
    choice value with `per_particle`; anything unmarked (an argument, a
    constraint, a value computed only from them) is shared by every
    particle and stored once.

    Under a `Vmap` the body runs under a stack of batch axes: the particle
    axis, then one lane axis per enclosing `Vmap`, always leading, in that
    order. A value's record is its depth: how many of those axes it
    carries, counted from the innermost (so a depth-1 value under the
    stack `(K, N)` is `(N, *event)`, shared by the particles, and a
    depth-2 value is `(K, N, *event)`, or `(K, 1, *event)` where it is the
    same in every lane: a batch axis of length 1 under a longer level
    stands for "the same in every lane"). `PerParticle` is the mark of
    depth 1; each deeper mark is a subclass of the one before, so PyTorch's
    own dispatch gives the result of an operation its deepest operand's
    mark, at no cost in Python."""

    _depth = 1


_MARKS: list[type] = [torch.Tensor, PerParticle]
MAX_DEPTH = 4
for _d in range(2, MAX_DEPTH + 1):
    _MARKS.append(type(f"Batched{_d}", (_MARKS[-1],), {"_depth": _d, "__doc__": f"The mark of depth {_d}."}))


def depth_of(x: Any) -> int:
    """How many leading batch axes `x` is marked as carrying (0: shared)."""
    return getattr(type(x), "_depth", 0) if isinstance(x, PerParticle) else 0


def mark(x: Any, depth: int) -> Any:
    """`x` marked as carrying `depth` leading batch axes (a view, no
    copy); values that are no tensors, and depth 0, pass through."""
    if not depth or not isinstance(x, torch.Tensor):
        return x
    if depth > MAX_DEPTH:
        raise ValueError(f"at most {MAX_DEPTH - 1} nested Vmaps under a particle axis")
    cls = _MARKS[depth]
    return x if type(x) is cls else plain(x).as_subclass(cls)


def per_particle(x: torch.Tensor) -> torch.Tensor:
    """Mark `x` as carrying the particle axis in front (a view, no copy).

    >>> import torch
    >>> from genjax_tpu_torch.core.typing import is_per_particle, per_particle
    >>> x = torch.zeros(4, 3)
    >>> is_per_particle(per_particle(x)), is_per_particle(x), is_per_particle(per_particle(x) + 1.0)
    (True, False, True)
    """
    return x if isinstance(x, PerParticle) else x.as_subclass(PerParticle)


def is_per_particle(x: Any) -> bool:
    return isinstance(x, PerParticle)


def plain(x: Any) -> Any:
    """`x` with its batch mark taken off (a view); other values pass
    through."""
    if not isinstance(x, PerParticle):
        return x
    with DisableTorchFunctionSubclass():
        return x.as_subclass(torch.Tensor)


def as_float(x: Any, device: torch.device | str | None = None) -> torch.Tensor:
    """`x` as a floating tensor without its batch mark (on `device`, if
    given): integer and boolean values take the default dtype."""
    x = plain(x) if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    x = x if x.is_floating_point() else x.to(torch.get_default_dtype())
    return x if device is None else x.to(device)


def batch_dims(n: "int | tuple | None") -> tuple:
    """The batch stack a method runs under, as a tuple of axis lengths:
    `None` is no batch axis, an int the particle axis alone, a tuple the
    stack as a `Vmap` hands it on."""
    if n is None:
        return ()
    return n if isinstance(n, tuple) else (n,)


def sample_shape(n: "int | tuple | None", *params: Any) -> torch.Size:
    """The shape of one site's draw: the broadcast of its parameters'
    per-particle shapes, with the batch axes `n` prepended (an int: the
    particle axis of that length; a tuple: the stack under a `Vmap`). A
    marked parameter contributes its shape without its batch axes; any
    other parameter is shared.

    >>> import torch
    >>> from genjax_tpu_torch.core.typing import mark, per_particle, sample_shape
    >>> tuple(sample_shape(8, torch.zeros(3), 1.0)), tuple(sample_shape(8, per_particle(torch.zeros(8))))
    ((8, 3), (8,))
    >>> tuple(sample_shape((8, 5), mark(torch.zeros(8, 1, 3), 2), torch.zeros(3)))
    (8, 5, 3)
    """
    shapes = [
        p.shape[p._depth :] if isinstance(p, PerParticle) else p.shape
        for p in params
        if isinstance(p, torch.Tensor)
    ]
    if all(s == shapes[0] for s in shapes[1:]):
        # One shape, or equal ones (as every parameter but one a number is):
        # no call to `broadcast_shapes`, whose Python costs about 15 us.
        base = shapes[0] if shapes else torch.Size()
    else:
        base = torch.broadcast_shapes(*shapes)
    if n is None:
        return base
    return torch.Size((n, *base)) if isinstance(n, int) else torch.Size((*n, *base))


class _IsValidator:
    """A predicate usable as `Annotated` metadata (JAX's stand-in for
    `beartype.vale.Is`), composable with `&`, `|` and `~`."""

    def __init__(self, predicate: Callable[[Any], bool]):
        self.predicate = predicate

    def __call__(self, value: Any) -> bool:
        return bool(self.predicate(value))

    def __and__(self, other: "_IsValidator") -> "_IsValidator":
        return _IsValidator(lambda v: self(v) and other(v))

    def __or__(self, other: "_IsValidator") -> "_IsValidator":
        return _IsValidator(lambda v: self(v) or other(v))

    def __invert__(self) -> "_IsValidator":
        return _IsValidator(lambda v: not self(v))


class Is:
    """`Is[predicate]` builds an `Annotated` validator.

    >>> from genjax_tpu_torch.core.typing import ScalarShaped
    >>> import torch
    >>> ScalarShaped(torch.tensor(1.0)), ScalarShaped(torch.zeros(2))
    (True, False)
    """

    def __class_getitem__(cls, predicate) -> _IsValidator:
        return _IsValidator(predicate)


#: The annotated value is scalar-shaped.
ScalarShaped = Is[lambda arr: torch.as_tensor(arr).shape == ()]
ScalarInt: TypeAlias = Annotated[IntArray, ScalarShaped]


def nobeartype(fn: Callable) -> Callable:
    """Exempt `fn` from the public-API type checks (`core/typecheck.py`
    skips a function with this mark)."""
    fn.__gx_typechecked__ = True
    return fn


def static_check_is_concrete(x: Any) -> bool:
    """True if `x` is no `torch.func` transform's wrapped tensor (JAX: no
    tracer): its value can be read."""
    if not isinstance(x, torch.Tensor):
        return True
    import torch._C._functorch as functorch

    return not functorch.is_functorch_wrapped_tensor(x)


def static_check_is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, int, float, bool))


def static_check_supports_grad(v: Any) -> bool:
    """True if `v` is a floating-point value (a differentiable leaf)."""
    return torch.as_tensor(v).is_floating_point()


def static_check_shape_dtype_equivalence(vs: list) -> bool:
    """True if every tensor in `vs` shares one (shape, dtype)."""
    return len({(tuple(v.shape), v.dtype) for v in vs}) == 1
