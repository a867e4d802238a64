"""Time-travel debugger: record checkpoints inside a computation and
navigate or modify them.

Counterpart of `genjax_tpu/utils/time_travel.py` (`rec`, `tag`,
`time_machine`, `TimeTravelingDebugger` with `fwd`/`bwd`/`jump`/`remix`),
pure Python over a thread-local stack, so the same in both packages.
`rec` records a frame in the innermost `time_machine` run and is the
identity outside one; `remix` runs the program again from the start with
the chosen frame's value replaced (a debugger's cost, never on a hot path).

>>> import torch
>>> from genjax_tpu_torch.utils.time_travel import rec, tag, time_machine
>>> def program(x):
...     a = rec(x + 1.0, "a")
...     return tag(a * 2.0, "b")
>>> dbg = time_machine(program)(torch.tensor(1.0))
>>> float(dbg.retval), dbg.n_frames, float(dbg.jump("a").remix(torch.tensor(10.0)).retval)
(4.0, 2, 20.0)
"""

import threading
from dataclasses import dataclass
from typing import Any, Callable

_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


class _Recorder:
    def __init__(self, overrides: dict | None = None):
        self.frames: list[tuple[str | None, Any]] = []
        self.overrides = overrides or {}

    def record(self, value, label):
        idx = len(self.frames)
        key = label if label is not None else idx
        if key in self.overrides:
            value = self.overrides[key]
        elif idx in self.overrides:
            value = self.overrides[idx]
        self.frames.append((label, value))
        return value


def rec(value: Any, label: str | None = None) -> Any:
    """Record a checkpoint. Returns `value` (possibly substituted when
    re-running under `remix`). Outside a `time_machine` run, identity."""
    stack = _stack()
    if not stack:
        return value
    return stack[-1].record(value, label)


def tag(value: Any, label: str) -> Any:
    """Labelled variant of `rec`."""
    return rec(value, label)


@dataclass
class TimeTravelingDebugger:
    """Navigator over the recorded frames of one execution."""

    fn: Callable[..., Any]
    args: tuple
    frames: list
    retval: Any
    cursor: int = 0

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def current(self):
        label, value = self.frames[self.cursor]
        return value

    def current_label(self):
        label, _ = self.frames[self.cursor]
        return label

    def fwd(self) -> "TimeTravelingDebugger":
        self.cursor = min(self.cursor + 1, self.n_frames - 1)
        return self

    def bwd(self) -> "TimeTravelingDebugger":
        self.cursor = max(self.cursor - 1, 0)
        return self

    def jump(self, where: int | str) -> "TimeTravelingDebugger":
        if isinstance(where, str):
            for i, (label, _) in enumerate(self.frames):
                if label == where:
                    self.cursor = i
                    return self
            raise KeyError(f"no frame labelled {where!r}")
        self.cursor = max(0, min(where, self.n_frames - 1))
        return self

    def remix(self, new_value: Any) -> "TimeTravelingDebugger":
        """Replace the value at the cursor and re-execute, producing a new
        debugger over the altered history."""
        label = self.current_label()
        key = label if label is not None else self.cursor
        return time_machine(self.fn, overrides={key: new_value})(*self.args)


def time_machine(
    fn: Callable[..., Any], *, overrides: dict | None = None
) -> Callable[..., TimeTravelingDebugger]:
    """Run `fn`, recording every `rec`/`tag` checkpoint; returns a
    `TimeTravelingDebugger` positioned at the first frame."""

    def runner(*args) -> TimeTravelingDebugger:
        recorder = _Recorder(overrides)
        _stack().append(recorder)
        try:
            retval = fn(*args)
        finally:
            _stack().pop()
        return TimeTravelingDebugger(fn, args, recorder.frames, retval)

    return runner
