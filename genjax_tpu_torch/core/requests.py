"""Core edit requests: `EmptyRequest`, `Regenerate` and
`UnsupportedBackwardRequest`.

Counterpart of part of `genjax_tpu/core/requests.py` (`Update` is in
`core/gfi.py`). `DiffAnnotate` waits for the site-graph analysis.
"""

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


__all__ = ["EmptyRequest", "Regenerate", "UnsupportedBackwardRequest"]
