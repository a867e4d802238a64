"""Core GFI type vocabulary: `Weight`, `Score`, `Arguments`, `Argdiffs`,
`Retdiff`, and the edit-request base classes.

Counterpart of `genjax_tpu/core/concepts.py`.
"""

from typing import Any

from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import FloatArray

Weight = FloatArray
"""A log density ratio arising from proper weighting."""

Score = FloatArray
"""A log density (or density estimate) of a trace's sample."""

Arguments = tuple
"""The type of argument tuples to generative functions."""

Argdiffs = tuple
"""Arguments whose leaves are `Diff` values (see `core/diff.py`)."""

Retdiff = Any
"""A return value whose leaves are `Diff` values."""


class EditRequest(Pytree):
    """A request for an SMCP3 move on a trace: `edit` returns the new
    trace, the incremental weight of the move, the retdiff and the
    backward request."""

    def edit(self, rng, tr, argdiffs: Argdiffs) -> tuple[Any, Weight, Retdiff, "EditRequest"]:
        raise NotImplementedError

    def dimap(self, /, *, pre=lambda v: v, post=lambda v: v) -> "EditRequest":
        """This request with its argdiffs mapped by `pre` and its retdiff
        by `post` (`core/requests.py::DiffAnnotate`)."""
        from genjax_tpu_torch.core.requests import DiffAnnotate

        return DiffAnnotate(self, argdiff_fn=pre, retdiff_fn=post)

    def map(self, post) -> "EditRequest":
        return self.dimap(post=post)

    def contramap(self, pre) -> "EditRequest":
        return self.dimap(pre=pre)


class PrimitiveEditRequest(EditRequest):
    """An edit request whose implementation is the generative function's
    own `edit` method."""

    def edit(self, rng, tr, argdiffs: Argdiffs):
        return tr.get_gen_fn().edit(rng, tr, self, argdiffs)


@Pytree.dataclass
class IndexRequest(PrimitiveEditRequest):
    """Request an edit at one index of a vector combinator's trace (one
    lane of a `Vmap`, one step of a `Scan`): slice, edit, scatter, instead
    of a full pass. `idx` is a Python int or a 0-d integer tensor."""

    idx: Any
    request: EditRequest


class NotSupportedEditRequest(Exception):
    pass
