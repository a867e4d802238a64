"""Values with change tangents (`Diff` leaves) for edits.

Counterpart of the part of `genjax_tpu/core/diff.py` that the edits use:
`Diff.no_change`, `Diff.unknown_change`, `Diff.tree_primal` and
`Diff.static_check_no_change`. The port's edits are dense (every site is
re-scored), so a tangent only tells a request whether the arguments
changed.
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
    def tree_primal(v) -> Any:
        return pytree.tree_map(lambda x: x.primal if isinstance(x, Diff) else x, v, is_leaf=_is_diff)

    @staticmethod
    def static_check_no_change(v) -> bool:
        """True if every `Diff` leaf in `v` carries `NoChange`."""
        return all(
            leaf.tangent is NoChange
            for leaf in pytree.tree_leaves(v, is_leaf=_is_diff)
            if isinstance(leaf, Diff)
        )


__all__ = ["ChangeTangent", "Diff", "NoChange", "UnknownChange"]
