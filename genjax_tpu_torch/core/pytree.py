"""`Pytree.dataclass` on `torch.utils._pytree`.

Counterpart of `genjax_tpu/core/pytree.py`. A dataclass declared with
`Pytree.dataclass` is registered as a pytree node: its dynamic fields are
children (tensors, nested pytrees), and fields declared with
`Pytree.static()` live in the node's context, out of the leaves, so a
`tree_map` over a trace never touches a generative function's source or a
particle count.
"""

import dataclasses
import functools
import types
from typing import Any, Callable, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

C = TypeVar("C", bound=type)
R = TypeVar("R")

_STATIC_MARK = "genjax_tpu_torch_static"


class Pytree:
    """Base of every structured value in the port: traces, choice maps,
    selections, generative functions and particle collections."""

    @staticmethod
    def dataclass(cls: C | None = None, /, *, match_args: bool = True) -> C:
        def wrap(kls):
            dkls = dataclasses.dataclass(kls, match_args=match_args, eq=False, repr=False)
            fields = dataclasses.fields(dkls)
            dyn_names = tuple(f.name for f in fields if not f.metadata.get(_STATIC_MARK))
            static_names = tuple(f.name for f in fields if f.metadata.get(_STATIC_MARK))

            def flatten(obj):
                children = [getattr(obj, name) for name in dyn_names]
                context = tuple(getattr(obj, name) for name in static_names)
                return children, context

            def unflatten(children, context):
                obj = object.__new__(dkls)
                for name, val in zip(dyn_names, children):
                    object.__setattr__(obj, name, val)
                for name, val in zip(static_names, context):
                    object.__setattr__(obj, name, val)
                return obj

            dkls._leafless = not dyn_names
            # A class may lay out its own node: `_flatten(obj)` and
            # `_unflatten(children, context)`, static methods.
            pytree.register_pytree_node(
                dkls,
                dkls.__dict__["_flatten"].__func__ if "_flatten" in dkls.__dict__ else flatten,
                dkls.__dict__["_unflatten"].__func__ if "_unflatten" in dkls.__dict__ else unflatten,
                serialized_type_name=f"{dkls.__module__}.{dkls.__qualname__}",
            )
            return dkls

        if cls is None:
            return wrap  # type: ignore[return-value]
        return wrap(cls)

    @staticmethod
    def static(**kwargs) -> Any:
        """A field kept in the node's context, out of the leaves."""
        md = dict(kwargs.pop("metadata", {}) or {})
        md[_STATIC_MARK] = True
        return dataclasses.field(metadata=md, **kwargs)

    @staticmethod
    def field(**kwargs) -> Any:
        """A dynamic field (a child of the node)."""
        return dataclasses.field(**kwargs)

    @staticmethod
    def partial(*partial_args) -> Callable[[Callable[..., R]], "Closure[R]"]:
        """Decorator: a `Closure` of the function with `partial_args`
        applied first."""

        def decorator(fn: Callable[..., R]) -> "Closure[R]":
            return Closure(partial_args, fn)

        return decorator

    def __repr__(self) -> str:
        parts = [f"{f.name}={getattr(self, f.name)!r}" for f in dataclasses.fields(self)]
        return f"{type(self).__name__}({', '.join(parts)})"


tree_map = pytree.tree_map


def _jax_order(node: Any) -> list:
    """The leaves of `node` in JAX's flatten order: a dict's children by
    sorted key (torch's `_pytree` keeps insertion order), every other
    node's children in the order of its own flatten."""
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _jax_order(node[k])]
    children = pytree.tree_flatten(node, is_leaf=lambda x: x is not node)[0]
    if len(children) == 1 and children[0] is node:
        return [node]
    return [leaf for child in children for leaf in _jax_order(child)]


def ravel_pytree(tree: Any, batch_shape: tuple = ()):
    """Flatten a pytree of tensors to one 1-D vector: `(flat, unravel)`,
    with `unravel(flat)` the tree back (JAX's
    `jax.flatten_util.ravel_pytree`). The leaves are concatenated in JAX's
    leaf order, a dict's children by sorted key, so a flat vector means the
    same in both packages; the vector takes the leaves' promoted dtype and
    `unravel` casts each leaf back to its own. With `batch_shape`, every
    leaf carries those leading axes and `flat` is `(*batch_shape, d)` (with
    `(n,)`, JAX's `vmap(lambda t: ravel_pytree(t)[0])` over n rows);
    `unravel` takes any leading axes in front of the `d` columns.

    >>> import torch
    >>> from genjax_tpu_torch.core.pytree import ravel_pytree
    >>> flat, unravel = ravel_pytree({"b": torch.tensor([1.0, 2.0]), "a": torch.tensor(3.0)})
    >>> flat.tolist(), unravel(flat)["b"].tolist()
    ([3.0, 1.0, 2.0], [1.0, 2.0])
    """
    batch_shape = tuple(batch_shape)
    leaves, spec = pytree.tree_flatten(tree)
    # Positions, in torch's leaf order, of the leaves in JAX's order.
    order = _jax_order(pytree.tree_unflatten(list(range(len(leaves))), spec))
    vals = [torch.as_tensor(leaves[i]) for i in order]
    dtype = functools.reduce(torch.promote_types, [v.dtype for v in vals]) if vals else torch.float32
    shapes = [v.shape[len(batch_shape) :] for v in vals]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    dtypes = [v.dtype for v in vals]
    if vals:
        flat = torch.cat([v.to(dtype).reshape((*batch_shape, -1)) for v in vals], dim=-1)
    else:
        flat = torch.zeros(*batch_shape, 0)

    def unravel(vec: torch.Tensor) -> Any:
        parts = torch.split(vec, sizes, dim=-1) if sizes else []
        out = list(leaves)
        for i, part, shape, dt in zip(order, parts, shapes, dtypes):
            out[i] = part.reshape((*vec.shape[:-1], *shape)).to(dt)
        return pytree.tree_unflatten(out, spec)

    return flat, unravel


def n_leaves(tree: Any) -> int:
    """The number of leaves of `tree`; a tensor is one, and a dataclass
    with only static fields (a generative function) none, with no flatten;
    a class that knows its count says so with its own `_n_leaves(self)`."""
    if isinstance(tree, torch.Tensor):
        return 1
    kls = type(tree)
    if kls.__dict__.get("_leafless", False):
        return 0
    count = kls.__dict__.get("_n_leaves")
    if count is not None:
        return count(tree)
    return len(pytree.tree_leaves(tree))


@Pytree.dataclass
class Const(Pytree):
    """A static value carried through a pytree as context, never as a leaf
    (JAX's `Const`, which keeps a value out of the tracers): a site's
    `sample_shape=Const((n,))`, a count.

    >>> from genjax_tpu_torch.core.pytree import Const
    >>> c = Const((3,))
    >>> c.unwrap(), Const.unwrap_value(c), Const.unwrap_value(4), n_leaves(c)
    ((3,), (3,), 4, 0)
    """

    const: Any = Pytree.static()

    def __call__(self, *args, **kwargs):
        return self.const(*args, **kwargs)

    def unwrap(self) -> Any:
        return self.const

    @staticmethod
    def unwrap_value(v: Any) -> Any:
        """`v`'s value if it is a `Const`, else `v` itself."""
        return v.const if isinstance(v, Const) else v


def _same(a: Any, b: Any) -> bool:
    """Equality of two values held by closure cells or defaults: functions
    by `_fn_eq`, tensors by identity, anything else by `==` where it
    answers a bool."""
    if a is b:
        return True
    if isinstance(a, types.FunctionType) and isinstance(b, types.FunctionType):
        return _fn_eq(a, b)
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor) or type(a) is not type(b):
        return False
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, Pytree):
        # By structure, as JAX's `_static_eq` does: a cell often holds a
        # generative function built in the same body (a `mix`'s `Switch`).
        la, sa = pytree.tree_flatten(a)
        lb, sb = pytree.tree_flatten(b)
        return sa == sb and len(la) == len(lb) and all(_same(x, y) for x, y in zip(la, lb))
    try:
        return bool(a == b)
    except Exception:
        return False


def _fn_eq(a: Any, b: Any) -> bool:
    """Two functions made by running the same `def` again: the same code
    and globals, equal defaults and equal closure cells."""
    if a is b:
        return True
    if not (isinstance(a, types.FunctionType) and isinstance(b, types.FunctionType)):
        return False
    if a.__code__ is not b.__code__ or a.__globals__ is not b.__globals__:
        return False
    if not (_same(a.__defaults__, b.__defaults__) and _same(a.__kwdefaults__, b.__kwdefaults__)):
        return False
    ca, cb = a.__closure__ or (), b.__closure__ or ()
    try:
        return len(ca) == len(cb) and all(_same(x.cell_contents, y.cell_contents) for x, y in zip(ca, cb))
    except ValueError:  # an empty cell
        return False


class _Fn:
    """A function in a pytree node's context. Running the same `def` again
    (a model that builds a callee in its body) makes a new function
    object; the treedef must not change for it, so equality is `_fn_eq`."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __eq__(self, other) -> bool:
        return isinstance(other, _Fn) and _fn_eq(self.fn, other.fn)

    def __hash__(self) -> int:
        return hash(getattr(self.fn, "__code__", self.fn))

    def __repr__(self) -> str:
        return f"_Fn({self.fn!r})"


@dataclasses.dataclass(eq=False, repr=False)
class Closure(Generic[R], Pytree):
    """A function with some arguments applied first: the arguments are
    children of the node (tensors among them are leaves), the function
    lives in its context (JAX's `Closure`).

    >>> import torch
    >>> import torch.utils._pytree as pytree
    >>> from genjax_tpu_torch.core.pytree import Closure
    >>> clo = Closure((torch.tensor(2.0),), lambda a, b: a * b)
    >>> float(clo(3.0)), len(pytree.tree_leaves(clo))
    (6.0, 1)
    """

    dyn_args: tuple
    fn: Callable[..., Any]

    def __call__(self, *args, **kwargs):
        return self.fn(*self.dyn_args, *args, **kwargs)


pytree.register_pytree_node(
    Closure,
    lambda c: (list(c.dyn_args), _Fn(c.fn)),
    lambda children, context: Closure(tuple(children), context.fn),
    serialized_type_name=f"{Closure.__module__}.Closure",
)


def nth(x: Any, idx) -> Any:
    """Index into every leaf of the pytree `x`.

    >>> import torch
    >>> from genjax_tpu_torch.core.pytree import nth
    >>> row = nth({"a": torch.arange(5), "b": torch.zeros(5, 2)}, 2)
    >>> int(row["a"]), tuple(row["b"].shape)
    (2, (2,))
    """
    return pytree.tree_map(lambda v: v[idx], x)


class PythonicPytree(Pytree):
    """Pytree mixin with `__getitem__` (index every leaf), `__len__` (the
    leading axis of the first leaf), `+` (concatenate leaf by leaf) and
    iteration over the leading axis."""

    def __getitem__(self, idx):
        return nth(self, idx)

    def __len__(self) -> int:
        leaves = pytree.tree_leaves(self)
        if not leaves:
            return 0
        return len(leaves[0])

    def __add__(self, other):
        return pytree.tree_map(lambda a, b: torch.cat([a, b]), self, other)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
