"""Generative function combinators: `vmap`, `scan` and its derived forms,
`dimap` / `map` / `contramap`, `repeat`, `switch`, `mask`, `mix` and
`or_else`."""

from genjax_tpu_torch.combinators.compose import RepeatCombinator, mix, or_else, repeat
from genjax_tpu_torch.combinators.dimap import Dimap, DimapTrace, contramap, dimap, map
from genjax_tpu_torch.combinators.mask import MaskCombinator, MaskTrace, mask
from genjax_tpu_torch.combinators.scan import (
    Scan,
    ScanTrace,
    VectorRequest,
    accumulate,
    iterate,
    iterate_final,
    masked_iterate,
    masked_iterate_final,
    prepend_initial_acc,
    reduce,
    scan,
)
from genjax_tpu_torch.combinators.switch import Switch, SwitchTrace, switch
from genjax_tpu_torch.combinators.vmap import Vmap, VmapTrace, vmap
from genjax_tpu_torch.core.concepts import IndexRequest

__all__ = [
    "Dimap",
    "DimapTrace",
    "IndexRequest",
    "MaskCombinator",
    "MaskTrace",
    "RepeatCombinator",
    "Scan",
    "ScanTrace",
    "Switch",
    "SwitchTrace",
    "VectorRequest",
    "Vmap",
    "VmapTrace",
    "accumulate",
    "contramap",
    "dimap",
    "iterate",
    "iterate_final",
    "map",
    "mask",
    "masked_iterate",
    "masked_iterate_final",
    "mix",
    "or_else",
    "prepend_initial_acc",
    "reduce",
    "repeat",
    "scan",
    "switch",
    "vmap",
]
