"""Values with change tangents (`Diff` leaves) for edits.

Counterpart of `genjax_tpu/core/diff.py`: `ChangeTangent`, `NoChange`,
`UnknownChange`, `Diff` with its tree helpers, and `incremental`. A
tangent is known when the program runs: it tells an edit which argument
leaves may have changed, and the static language's edit plan
(`lang/static.py`, from the site graph of `lang/analysis.py`) hands each
site per-leaf tangents, so that a site whose arguments did not change is
kept or edited without re-scoring.
"""

from typing import Any

import torch.utils._pytree as pytree

from genjax_tpu_torch.core.pytree import Pytree


class ChangeTangent(Pytree):
    """Base class for change tangents attached to `Diff` values."""

    def __repr__(self):
        return type(self).__name__


@Pytree.dataclass
class _UnknownChange(ChangeTangent):
    pass


@Pytree.dataclass
class _NoChange(ChangeTangent):
    pass


UnknownChange = _UnknownChange()
NoChange = _NoChange()


def _is_diff(x) -> bool:
    return isinstance(x, Diff)


@Pytree.dataclass
class Diff(Pytree):
    """A value paired with a change tangent (`NoChange` or `UnknownChange`).

    >>> from genjax_tpu_torch.core.diff import Diff
    >>> Diff.static_check_no_change(Diff.no_change((1.0, 2.0)))
    True
    >>> Diff.tree_primal(Diff.unknown_change((1.0, 2.0)))
    (1.0, 2.0)
    """

    primal: Any
    tangent: ChangeTangent = Pytree.static(default=UnknownChange)

    def get_primal(self) -> Any:
        return self.primal

    def get_tangent(self) -> ChangeTangent:
        return self.tangent

    @staticmethod
    def unknown_change(v) -> Any:
        """Wrap every leaf of `v` as changed."""
        return pytree.tree_map(lambda x: Diff(Diff.tree_primal(x), UnknownChange), v, is_leaf=_is_diff)

    @staticmethod
    def no_change(v) -> Any:
        """Wrap every leaf of `v` as unchanged."""
        return pytree.tree_map(lambda x: Diff(Diff.tree_primal(x), NoChange), v, is_leaf=_is_diff)

    @staticmethod
    def tree_diff(primal_tree, tangent_tree) -> Any:
        """Pair a primal tree with a tree of `ChangeTangent`s of the same
        structure."""
        return pytree.tree_map(lambda p, t: Diff(p, t), primal_tree, tangent_tree, is_leaf=_is_diff)

    @staticmethod
    def tree_primal(v) -> Any:
        return pytree.tree_map(lambda x: x.primal if isinstance(x, Diff) else x, v, is_leaf=_is_diff)

    @staticmethod
    def tree_tangent(v) -> Any:
        """The tangent of every leaf of `v`: a `Diff`'s own, else
        `UnknownChange`."""
        return pytree.tree_map(lambda x: x.tangent if isinstance(x, Diff) else UnknownChange, v, is_leaf=_is_diff)

    @staticmethod
    def static_check_tree_diff(v) -> bool:
        """True if every leaf of `v` is a `Diff`."""
        return all(isinstance(leaf, Diff) for leaf in pytree.tree_leaves(v, is_leaf=_is_diff))

    @staticmethod
    def static_check_no_change(v) -> bool:
        """True if every `Diff` leaf in `v` carries `NoChange`."""
        return all(
            leaf.tangent is NoChange
            for leaf in pytree.tree_leaves(v, is_leaf=_is_diff)
            if isinstance(leaf, Diff)
        )


def rediff(args: Any, argdiffs: Any) -> Any:
    """`args` (a slice or a re-layout of `argdiffs`' primals, in one
    structure) with `argdiffs`' tangents, leaf for leaf; all
    `UnknownChange` where the structures differ."""
    try:
        return Diff.tree_diff(args, Diff.tree_tangent(argdiffs))
    except Exception:  # noqa: BLE001 - coarse is always correct
        return Diff.unknown_change(args)


def incremental(fn):
    """Change propagation at the grain of a whole function:
    `incremental(fn)(handler, primals, tangents)` runs `fn` on the primals
    and tags every leaf of its result `NoChange` if every input leaf was
    `NoChange`, else `UnknownChange` (JAX's rule; the handler slot is kept
    for the reference's signature and ignored).

    >>> from genjax_tpu_torch.core.diff import Diff, NoChange, UnknownChange, incremental
    >>> add = incremental(lambda a, b: a + b)
    >>> Diff.static_check_no_change(add(None, (1.0, 2.0), (NoChange, NoChange)))
    True
    >>> add(None, (1.0, 2.0), (NoChange, UnknownChange)).tangent
    _UnknownChange
    """

    def wrapped(_handler, primals, tangents):
        diffs = Diff.tree_diff(primals, tangents)
        out = fn(*primals)
        if Diff.static_check_no_change(diffs):
            return Diff.no_change(out)
        return Diff.unknown_change(out)

    return wrapped


__all__ = ["ChangeTangent", "Diff", "NoChange", "UnknownChange", "incremental"]
