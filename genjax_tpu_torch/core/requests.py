"""Core edit requests: `EmptyRequest`, `Regenerate`,
`UnsupportedBackwardRequest` and `DiffAnnotate`.

Counterpart of `genjax_tpu/core/requests.py` (`Update` is in
`core/gfi.py`). `DiffAnnotate` rewrites the argdiffs a request sees and
the retdiff it returns (`EditRequest.dimap`, `map`, `contramap`): with
incremental edits a retdiff says what the static analysis proved, so a
`map` can assert it (`inference/requests/hmc.py::SafeHMC`).
"""

from typing import Any

import torch

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import Argdiffs, EditRequest, NotSupportedEditRequest, PrimitiveEditRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import Trace, Update
from genjax_tpu_torch.core.pytree import Pytree


@Pytree.dataclass
class EmptyRequest(EditRequest):
    """No-op request; an `Update` with an empty constraint if the arguments
    changed."""

    def edit(self, rng: torch.Generator, tr: Trace, argdiffs: Argdiffs):
        if Diff.static_check_no_change(argdiffs):
            weight = torch.zeros((), device=rng.device)
            return tr, weight, Diff.no_change(tr.get_retval()), EmptyRequest()
        return Update(ChoiceMap.empty()).edit(rng, tr, argdiffs)


@Pytree.dataclass
class Regenerate(PrimitiveEditRequest):
    """Resample the selected addresses from their prior. The weight is the
    change of the joint score (`mcmc.mh` subtracts the proposal terms with
    `project`)."""

    selection: Selection


@Pytree.dataclass
class UnsupportedBackwardRequest(EditRequest):
    """The backward request of a move whose reverse is no single request
    (a `Switch` edit whose branches' backward requests differ in kind).
    The forward move and its weight are valid; running this one raises."""

    reason: str = Pytree.static(default="")

    def edit(self, rng, tr, argdiffs: Argdiffs):
        raise NotSupportedEditRequest(f"This edit's backward request is not representable: {self.reason}")


def _identity(v):
    return v


@Pytree.dataclass
class DiffAnnotate(EditRequest):
    """Another request with its argdiffs mapped by `argdiff_fn` before it
    runs and its retdiff by `retdiff_fn` after (unchecked: the functions
    are trusted, as in JAX)."""

    request: EditRequest
    argdiff_fn: Any = Pytree.static(default=_identity)
    retdiff_fn: Any = Pytree.static(default=_identity)

    def edit(self, rng: torch.Generator, tr: Trace, argdiffs: Argdiffs):
        tr, w, retdiff, bwd = self.request.edit(rng, tr, self.argdiff_fn(argdiffs))
        return tr, w, self.retdiff_fn(retdiff), bwd


__all__ = ["DiffAnnotate", "EmptyRequest", "Regenerate", "UnsupportedBackwardRequest"]
