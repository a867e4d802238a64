"""`Rejuvenate`: MH with a custom proposal as an SMCP3 edit request.

Counterpart of `genjax_tpu/inference/requests/rejuvenate.py`: the weight is
the MH acceptance ratio (accept or reject is the caller's, e.g.
`inference.mcmc.mh`). Over a batch of particles the proposal runs once for
all of them: `argument_mapping` is handed the choices with their
per-particle values marked (`core/typing.py`), so the arguments it derives
carry the particle axis into the proposal.
"""

from typing import Any, Callable, TypeVar

import torch

from genjax_tpu_torch.core.choice_map import Choice, ChoiceMap
from genjax_tpu_torch.core.concepts import Argdiffs, EditRequest, Retdiff, Weight
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.mask import Mask
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.typing import mark

R = TypeVar("R")


def marked_choices(chm: ChoiceMap) -> ChoiceMap:
    """`chm` with each value marked with its depth, so that what a mapping
    computes from a per-particle value is per particle too."""

    def one(c: Choice) -> ChoiceMap:
        return c if isinstance(c.v, Mask) else Choice(mark(c.v, c.batched), c.batched)

    return chm.map_choices(one)


@Pytree.dataclass
class Rejuvenate(EditRequest):
    """Propose a change to a trace with a proposal generative function.

    `argument_mapping` maps the trace's choices to the proposal's
    arguments; the same proposal serves as the K and the L kernel of the
    SMCP3 move, so the weight is exactly the MH acceptance ratio.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> from genjax_tpu_torch.inference.requests import Rejuvenate
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> @gx.gen
    ... def walk(x):
    ...     _ = gx.normal(x, 0.5) @ "x"
    >>> rng = torch.Generator().manual_seed(0)
    >>> tr, _ = model.importance(rng, gx.ChoiceMap.kw(y=1.0), (), n=16)
    >>> new, accepted = gx.mh(rng, tr, Rejuvenate(walk, lambda chm: (chm["x"],)))
    >>> new.get_choices()["x"].shape, accepted.shape
    (torch.Size([16]), torch.Size([16]))
    """

    proposal: GenerativeFunction[Any]
    argument_mapping: Callable[[ChoiceMap], Any] = Pytree.static()

    def edit(self, rng: torch.Generator, tr: Trace[Any], argdiffs: Argdiffs) -> tuple[Trace[Any], Weight, Retdiff, EditRequest]:
        n = tr.particle_count()
        fwd_args = self.argument_mapping(marked_choices(tr.get_choices()))
        proposed, fwd_score, _ = self.proposal.propose(rng, fwd_args, n)
        new_tr, w, retdiff, bwd_request = Update(proposed).edit(rng, tr, argdiffs)
        assert isinstance(bwd_request, Update)
        # The backward kernel's density: the probability that the proposal,
        # run from the NEW trace, would give the discarded (old) values.
        # (The reference derives these arguments from the discard, which
        # mis-weights an asymmetric proposal; the new choices give the
        # correct L kernel and make the weight the exact MH ratio.)
        bwd_args = self.argument_mapping(marked_choices(new_tr.get_choices()))
        bwd_score, _ = self.proposal.assess(bwd_request.constraint, bwd_args, n)
        return new_tr, w + bwd_score - fwd_score, retdiff, Rejuvenate(self.proposal, self.argument_mapping)
