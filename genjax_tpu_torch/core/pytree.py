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
