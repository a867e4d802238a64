"""Generative function combinators: `vmap`, `scan` and its derived forms,
`dimap` / `map` / `contramap`, `repeat`. `switch`, `mask`, `mix`,
`or_else` and `masked_iterate*` come later."""

from genjax_tpu_torch.combinators.compose import RepeatCombinator, repeat
from genjax_tpu_torch.combinators.dimap import Dimap, DimapTrace, contramap, dimap, map
from genjax_tpu_torch.combinators.scan import (
    Scan,
    ScanTrace,
    VectorRequest,
    accumulate,
    iterate,
    iterate_final,
    prepend_initial_acc,
    reduce,
    scan,
)
from genjax_tpu_torch.combinators.vmap import Vmap, VmapTrace, vmap

__all__ = [
    "Dimap",
    "DimapTrace",
    "RepeatCombinator",
    "Scan",
    "ScanTrace",
    "VectorRequest",
    "Vmap",
    "VmapTrace",
    "accumulate",
    "contramap",
    "dimap",
    "iterate",
    "iterate_final",
    "map",
    "prepend_initial_acc",
    "reduce",
    "repeat",
    "scan",
    "vmap",
]
