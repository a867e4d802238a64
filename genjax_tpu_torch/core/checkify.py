"""The gate of opt-in runtime value checks.

Counterpart of `genjax_tpu/core/checkify.py`: `optional_check(thunk)` runs
`thunk` only inside a `do_checkify()` block. In JAX the thunk stages
`checkify.check` assertions; here it reads the device and raises at once,
which is why the gate stays closed by default: a check is a host read (a
synchronisation with a CUDA device) that the hot paths must not pay.

>>> from genjax_tpu_torch.core.checkify import do_checkify, optional_check, should_check
>>> ran = []
>>> optional_check(lambda: ran.append("outside"))
>>> with do_checkify():
...     optional_check(lambda: ran.append("inside"))
>>> ran, should_check()
(['inside'], False)
"""

from contextlib import contextmanager

_CHECKIFY_STACK: list[bool] = []


def should_check() -> bool:
    return bool(_CHECKIFY_STACK) and _CHECKIFY_STACK[-1]


def optional_check(thunk) -> None:
    if should_check():
        thunk()


@contextmanager
def do_checkify():
    _CHECKIFY_STACK.append(True)
    try:
        yield
    finally:
        _CHECKIFY_STACK.pop()
