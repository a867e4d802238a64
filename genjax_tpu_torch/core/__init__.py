"""Core layer: pytrees, choice maps and selections, the GFI, edit
requests, masks, the staging helpers, and the check gates (counterpart of
`genjax_tpu/core/__init__.py`)."""

from genjax_tpu_torch.core.checked import checked_mode, do_checked
from genjax_tpu_torch.core.checkify import do_checkify, optional_check
from genjax_tpu_torch.core.choice_map import (
    Address,
    AddressComponent,
    ChoiceMap,
    ChoiceMapBuilder,
    Selection,
    SelectionBuilder,
    StaticAddress,
    StaticAddressComponent,
)
from genjax_tpu_torch.core.concepts import (
    Argdiffs,
    Arguments,
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_tpu_torch.core.diff import ChangeTangent, Diff, NoChange, UnknownChange, incremental
from genjax_tpu_torch.core.gather import take_rows
from genjax_tpu_torch.core.gfi import (
    GenerativeFunction,
    GenerativeFunctionClosure,
    IgnoreKwargs,
    Trace,
    Update,
)
from genjax_tpu_torch.core.mask import Mask
from genjax_tpu_torch.core.pytree import Closure, Const, Pytree, PythonicPytree, nth
from genjax_tpu_torch.core.requests import DiffAnnotate, EmptyRequest, Regenerate
from genjax_tpu_torch.core.staging import FlagOp, empty_trace, multi_switch, to_shape_fn, tree_choose
from genjax_tpu_torch.core.typecheck import do_typecheck, is_typechecked
from genjax_tpu_torch.core.typing import R

__all__ = [
    "Address",
    "AddressComponent",
    "Argdiffs",
    "Arguments",
    "ChangeTangent",
    "ChoiceMap",
    "ChoiceMapBuilder",
    "Closure",
    "Const",
    "Diff",
    "DiffAnnotate",
    "EditRequest",
    "EmptyRequest",
    "FlagOp",
    "GenerativeFunction",
    "GenerativeFunctionClosure",
    "IgnoreKwargs",
    "IndexRequest",
    "Mask",
    "NoChange",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Pytree",
    "PythonicPytree",
    "R",
    "Regenerate",
    "Retdiff",
    "Score",
    "Selection",
    "SelectionBuilder",
    "StaticAddress",
    "StaticAddressComponent",
    "Trace",
    "UnknownChange",
    "Update",
    "Weight",
    "checked_mode",
    "do_checked",
    "do_checkify",
    "do_typecheck",
    "empty_trace",
    "incremental",
    "is_typechecked",
    "multi_switch",
    "nth",
    "optional_check",
    "take_rows",
    "to_shape_fn",
    "tree_choose",
]
