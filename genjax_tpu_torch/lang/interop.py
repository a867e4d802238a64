"""The addressing intrinsic (`dist(args) @ "addr"`) and its handler stack.

Counterpart of `genjax_tpu/lang/interop.py`. Each GFI method of a `@gen`
function runs the model's source once with a method-specific handler
installed; `@ "addr"` dispatches to the innermost handler. The stack is
thread-local, so two threads can run models at once.
"""

import threading
from typing import Any

_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


class TraceHandler:
    """Interface for handlers that interpret `trace(addr, gen_fn, args)`
    calls made inside a generative program's source."""

    def handle_trace(self, addr, gen_fn, args) -> Any:
        raise NotImplementedError


class handler_context:
    def __init__(self, handler: TraceHandler):
        self.handler = handler

    def __enter__(self):
        _stack().append(self.handler)
        return self.handler

    def __exit__(self, *exc):
        _stack().pop()
        return False


def current_handler() -> TraceHandler:
    """The innermost installed handler: where a handler that rewrites a
    site before the method's own handler sees it forwards the site."""
    stack = _stack()
    if not stack:
        raise RuntimeError("current_handler() outside a GFI method")
    return stack[-1]


def static_check_address(addr) -> None:
    components = addr if isinstance(addr, tuple) else (addr,)
    for comp in components:
        if not isinstance(comp, str):
            raise TypeError(
                f"Addresses in the @gen language must be static strings (or "
                f"tuples of strings); got {comp!r} of type {type(comp)}."
            )


def trace(addr, gen_fn, args) -> Any:
    """Invoke a generative function at an address, under the innermost
    enclosing generative context."""
    static_check_address(addr)
    stack = _stack()
    if not stack:
        raise RuntimeError(
            f"`@ {addr!r}` outside a GFI method: call the model through "
            "simulate / assess / generate / importance."
        )
    return stack[-1].handle_trace(addr, gen_fn, args)
