"""`Pytree.dataclass` on `torch.utils._pytree`.

Counterpart of `genjax_tpu/core/pytree.py`. A dataclass declared with
`Pytree.dataclass` is registered as a pytree node: its dynamic fields are
children (tensors, nested pytrees), and fields declared with
`Pytree.static()` live in the node's context, out of the leaves, so a
`tree_map` over a trace never touches a generative function's source or a
particle count.
"""

import dataclasses
from typing import Any, TypeVar

import torch
import torch.utils._pytree as pytree

C = TypeVar("C", bound=type)

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
            pytree.register_pytree_node(
                dkls,
                flatten,
                unflatten,
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

    def __repr__(self) -> str:
        parts = [f"{f.name}={getattr(self, f.name)!r}" for f in dataclasses.fields(self)]
        return f"{type(self).__name__}({', '.join(parts)})"


tree_map = pytree.tree_map


def n_leaves(tree: Any) -> int:
    """The number of leaves of `tree`; a tensor is one, and a dataclass
    with only static fields (a generative function) none, with no flatten."""
    if isinstance(tree, torch.Tensor):
        return 1
    if type(tree).__dict__.get("_leafless", False):
        return 0
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
