"""Opt-in validation of GFI entry-point inputs.

Counterpart of `genjax_tpu/core/checked.py`. `checked_mode()` (or
`do_checked(True)`) turns on targeted messages for the classic call
mistakes: swapped arguments, a dict where a `ChoiceMap` belongs, arguments
not packed in a tuple, a raw int seed where a `torch.Generator` belongs.
Each call site is one `if checked.is_checked():`, so nothing runs when the
mode is off. While the mode is on, the public-API wrappers of
`core/typecheck.py` are on too, whatever `do_typecheck` says.

>>> import torch
>>> import genjax_tpu_torch as gx
>>> from genjax_tpu_torch.core.checked import check_key, checked_mode
>>> with checked_mode():
...     try:
...         check_key(42, "simulate")  # a raw seed instead of a generator
...     except TypeError as e:
...         print("caught:", "torch.Generator" in str(e))
caught: True
"""

import contextlib
from typing import Any

import torch

from genjax_tpu_torch.core.typing import nobeartype

_ENABLED = False


def _changed() -> None:
    from genjax_tpu_torch.core import typecheck

    typecheck.sync()


@nobeartype  # the switch stays out of the wrappers it switches
def do_checked(enable: bool = True) -> None:
    """Globally enable/disable GFI input validation."""
    global _ENABLED
    _ENABLED = enable
    _changed()


def is_checked() -> bool:
    return _ENABLED


@contextlib.contextmanager
def checked_mode():
    """Context manager: validate GFI entry-point inputs inside the block."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = True
    _changed()
    try:
        yield
    finally:
        _ENABLED = prev
        _changed()


def _is_generator(rng: Any) -> bool:
    return isinstance(rng, torch.Generator)


def check_key(rng: Any, where: str) -> None:
    """JAX's `check_key`: here the key is a `torch.Generator`."""
    if _ENABLED and not _is_generator(rng):
        raise TypeError(
            f"{where}: `rng` must be a torch.Generator; got {type(rng).__name__}: {rng!r}. "
            "A raw int seed is not a generator: wrap it, "
            "torch.Generator(device=...).manual_seed(seed)."
        )


def check_args(args: Any, where: str) -> None:
    if _ENABLED and not isinstance(args, tuple):
        raise TypeError(
            f"{where}: `args` must be the argument TUPLE (use `(x,)` for a "
            f"single argument, `()` for none); got {type(args).__name__}."
        )


def check_choice_map(chm: Any, where: str, what: str = "constraint") -> None:
    if not _ENABLED:
        return
    from genjax_tpu_torch.core.choice_map import ChoiceMap

    if not isinstance(chm, ChoiceMap):
        hint = ""
        if isinstance(chm, dict):
            hint = " Build one from a dict with ChoiceMap.d({...}) or ChoiceMap.kw(...)."
        raise TypeError(f"{where}: `{what}` must be a ChoiceMap; got {type(chm).__name__}.{hint}")


def check_selection(sel: Any, where: str) -> None:
    if not _ENABLED:
        return
    from genjax_tpu_torch.core.choice_map import Selection

    if not isinstance(sel, Selection):
        raise TypeError(f"{where}: expected a Selection (e.g. Selection.at['x']); got {type(sel).__name__}.")


def check_request(req: Any, where: str) -> None:
    if not _ENABLED:
        return
    from genjax_tpu_torch.core.concepts import EditRequest

    if not isinstance(req, EditRequest):
        raise TypeError(
            f"{where}: expected an EditRequest (Update(...), Regenerate(...), "
            f"HMC(...), ...); got {type(req).__name__}."
        )
