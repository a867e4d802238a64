"""`Scan` combinator: sequential composition `(c, a) -> (c, b)` over a
fixed number of steps, plus the derived decorators (`accumulate`,
`reduce`, `iterate`, `iterate_final`, `masked_iterate`,
`masked_iterate_final`).

Counterpart of `genjax_tpu/combinators/scan.py`: simulate, generate,
assess, project, the `Update` / `Regenerate` re-scan edits, the
`IndexRequest` single-step edit with its revisit of the next step, and
`VectorRequest`.

JAX traces the kernel once for `lax.scan`. Here the steps are a Python
loop, as the bootstrap filter's are: the first steps run the kernel with
batch marks to learn its record (until the record of a step equals the
one before: a carry that starts shared and becomes per particle settles
after two), every later step runs `like=` that trace on plain tensors.
Each leaf of the per-step traces is written into a buffer allocated once,
with the time axis right behind the leaf's batch axes: `(K, T, *e)` for a
per-particle leaf, `(T, *e)` for a shared one. So `chm["z"]` is the whole
`(K, T)` array, `chm[t, "z"]` step `t`, and no step reads a device value on
the host.
"""

from typing import Any, Generic, TypeVar

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.combinators.dimap import Dimap
from genjax_tpu_torch.combinators.vmap import _check_indexable
from genjax_tpu_torch.core.checkify import should_check
from genjax_tpu_torch.core.choice_map import ChoiceMap, NoneSel, Selection
from genjax_tpu_torch.core.concepts import (
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Score,
    Weight,
)
from genjax_tpu_torch.core.diff import Diff, rediff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.pytree import Pytree, n_leaves
from genjax_tpu_torch.core.requests import EmptyRequest, Regenerate
from genjax_tpu_torch.core.typing import batch_dims, depth_of, device_of, mark, plain
from genjax_tpu_torch.distributions.distribution import _drop
from genjax_tpu_torch.lang.static import _recorded, marked_like

Carry = TypeVar("Carry")
Y = TypeVar("Y")


def _is_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


class _Steps:
    """The per-step slices of the scanned-over arguments: each leaf is
    cut along its first axis past its batch axes."""

    def __init__(self, xs: Any, length: int | None, record: list | None = None):
        leaves, self.spec = pytree.tree_flatten(xs)
        self.depths = [depth_of(v) for v in leaves] if record is None else list(record)
        self.leaves = [plain(v) for v in leaves]
        lengths = {v.shape[d] for v, d in zip(self.leaves, self.depths) if _is_tensor(v)}
        if len(lengths) > 1 or (length is not None and lengths - {length}):
            raise ValueError(f"scan: the scanned arguments' lengths {sorted(lengths)} disagree (length={length})")
        if length is None and not lengths:
            raise ValueError("scan: give the number of steps (`n=`) where no argument is scanned over")
        self.length = length if length is not None else lengths.pop()

    def at(self, t, marks: bool = False):
        out = []
        for v, d in zip(self.leaves, self.depths):
            if _is_tensor(v):
                v = v.select(d, t) if isinstance(t, int) else v.index_select(d, t.reshape(1).to(v.device)).squeeze(d)
                v = mark(v, d) if marks else v
            out.append(v)
        return pytree.tree_unflatten(out, self.spec)

    def template(self, marks: bool = False):
        """Zeros in the shape of one step's slice: what a run over zero
        steps hands its kernel to learn the trace's structure."""
        out = []
        for v, d in zip(self.leaves, self.depths):
            if _is_tensor(v):
                v = v.new_zeros(v.shape[:d] + v.shape[d + 1 :])
                v = mark(v, d) if marks else v
            out.append(v)
        return pytree.tree_unflatten(out, self.spec)


class _Buffers:
    """One buffer per leaf of the kernel's trace, allocated once from a
    trace with the settled record, the time axis behind the leaf's batch
    axes. A step whose leaf is narrower (a shared carry-in at step 0) is
    broadcast into its slot."""

    def __init__(self, template: Trace, length: int):
        leaves, self.spec = pytree.tree_flatten(template)
        self.depths = template.batched_leaves()
        self.bufs = [
            v.new_empty(v.shape[:d] + (length,) + v.shape[d:]) if _is_tensor(v) else v
            for v, d in zip(leaves, self.depths)
        ]

    def write(self, t: int, tr: Trace) -> None:
        for buf, v, d in zip(self.bufs, pytree.tree_leaves(tr), self.depths):
            if not _is_tensor(buf):
                continue
            slot = buf.select(d, t)
            slot.copy_(v) if _is_tensor(v) else slot.fill_(v)

    def stacked(self) -> Trace:
        return pytree.tree_unflatten(self.bufs, self.spec)


def _step(stacked: Any, t, depths: list | None = None) -> Any:
    """Step `t` (an int or a 0-d index tensor) of a stacked trace or
    choice map."""
    leaves, spec = pytree.tree_flatten(stacked)
    depths = stacked.batched_leaves() if depths is None else depths
    out = []
    for v, d in zip(leaves, depths):
        if _is_tensor(v):
            v = v.select(d, t) if isinstance(t, int) else v.index_select(d, t.reshape(1).to(v.device)).squeeze(d)
        out.append(v)
    return pytree.tree_unflatten(out, spec)


def _put_step(stacked: Trace, new: Trace, t, where=None) -> Trace:
    """`stacked` with step `t` replaced by `new` (only where `where`, a
    0-d boolean tensor, is true), as a copy."""
    leaves, spec = pytree.tree_flatten(stacked)
    at = torch.as_tensor(t).reshape(1)
    out = []
    for v, s, d in zip(leaves, pytree.tree_leaves(new), stacked.batched_leaves()):
        if not _is_tensor(v):
            out.append(v)
            continue
        s = torch.as_tensor(s, dtype=v.dtype, device=v.device).expand(v.shape[:d] + v.shape[d + 1 :])
        if where is not None:
            s = torch.where(where, s, v.index_select(d, at.to(v.device)).squeeze(d))
        out.append(v.index_copy(d, at.to(v.device), s.unsqueeze(d)))
    return pytree.tree_unflatten(out, spec)


def _stack(trees: list, depths: list) -> Any:
    """Per-step trees of one structure as one tree of stacked leaves."""
    flat = [pytree.tree_flatten(t) for t in trees]
    spec = flat[-1][1]
    out = []
    for i, d in enumerate(depths):
        column = [leaves[i] for leaves, _ in flat]
        if not any(_is_tensor(v) for v in column):
            out.append(column[-1])
            continue
        ref = next(v for v in reversed(column) if _is_tensor(v))
        column = [torch.as_tensor(v, dtype=ref.dtype, device=ref.device).expand(ref.shape) for v in column]
        out.append(torch.stack(column, dim=d))
    return pytree.tree_unflatten(out, spec)


def _signature(tr: Trace) -> tuple:
    return tuple(tr.batched_leaves()), tuple(_is_tensor(v) for v in pytree.tree_leaves(tr))


@Pytree.dataclass
class ScanTrace(Generic[Carry, Y], Trace[tuple[Carry, Y]]):
    """`inner` is the kernel's trace with every leaf stacked over the
    steps: its score is per step, `(K, T)`."""

    scan_gen_fn: "Scan[Carry, Y]"
    inner: Trace[tuple[Carry, Y]]
    args: tuple
    retval: tuple[Carry, Y]
    score: Any
    scan_length: int = Pytree.static(default=0)
    args_batched: tuple = Pytree.static(default=())
    retval_batched: tuple = Pytree.static(default=())
    score_batched: int = Pytree.static(default=0)

    @staticmethod
    def build(gen_fn, inner: Trace, args: tuple, args_batched: tuple, c_final, length: int) -> "ScanTrace":
        record = inner.retval_record()
        retval = (c_final, inner.get_retval()[1])
        score = inner.get_score()
        score = score.sum(-1) if _is_tensor(score) and score.dim() else score * length
        depth = score.dim() if _is_tensor(score) else 0
        return ScanTrace(gen_fn, inner, args, retval, score, length, tuple(args_batched), tuple(record), depth)

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_choices(self) -> ChoiceMap:
        return self.inner.add_gap().get_choices()

    def add_gap(self, k: int = 1) -> "ScanTrace":
        inner = self.inner.add_gap(k)
        if inner is self.inner:
            return self
        return ScanTrace(
            self.scan_gen_fn, inner, self.args, self.retval, self.score, self.scan_length,
            self.args_batched, self.retval_batched, self.score_batched,
        )

    def get_gen_fn(self):
        return self.scan_gen_fn

    def get_score(self):
        return self.score

    def get_inner_trace(self, address):
        return self.inner.get_inner_trace(address)

    def args_record(self) -> list[int]:
        return list(self.args_batched) or [0] * n_leaves(self.args)

    def retval_record(self) -> list[int]:
        return list(self.retval_batched) or [0] * n_leaves(self.retval)

    def batched_leaves(self) -> list[int]:
        return (
            [0] * n_leaves(self.scan_gen_fn)
            + self.inner.batched_leaves()
            + self.args_record()
            + self.retval_record()
            + [self.score_batched]
        )

    def drop_level(self, r: int = 0) -> "ScanTrace":
        return ScanTrace(
            self.scan_gen_fn,
            self.inner.drop_level(r),
            self.args,
            self.retval,
            self.score,
            self.scan_length,
            tuple(_drop(d, r) for d in self.args_batched),
            tuple(_drop(d, r) for d in self.retval_batched),
            _drop(self.score_batched, r),
        )


@Pytree.dataclass
class VectorRequest(PrimitiveEditRequest):
    """A sub-request for every step: one stacked request, whose tensor
    leaves carry the step axis right behind their batch axes (step `t`
    gets slice `t` of every leaf, as in JAX), or a tuple of per-step
    requests (the backward request of a re-scan `Regenerate`: the steps'
    requests differ in structure where the selection names one step, so
    they are not stacked)."""

    request: Any

    def at_step(self, t: int) -> EditRequest:
        """The sub-request of step `t`."""
        if isinstance(self.request, (tuple, list)):
            return self.request[t]
        if isinstance(self.request, Update):
            # A choice map keeps the record of its leaves' batch axes.
            return Update(_step(self.request.constraint, t))
        leaves, spec = pytree.tree_flatten(self.request)
        return pytree.tree_unflatten(
            [mark(v.select(depth_of(v), t), depth_of(v)) if _is_tensor(v) else v for v in leaves], spec
        )


@Pytree.dataclass
class Scan(Generic[Carry, Y], GenerativeFunction[tuple[Carry, Y]]):
    """Scan a kernel of type `(c, a) -> (c, b)` into a generative function
    of type `(c, [a]) -> (c, [b])`. Step `t`'s choices nest under the
    integer address `t`. Inside `do_checkify()`, an `IndexRequest` edit
    verifies (with a read of the device) that the carry out of the
    revisited step is what it was.

    >>> import torch
    >>> import genjax_tpu_torch as gx
    >>> @gx.scan(n=3)
    ... @gx.gen
    ... def walk(x, _):
    ...     y = gx.normal(x, 1.0) @ "x"
    ...     return y, y
    >>> obs = gx.ChoiceMap.kw(x=torch.tensor([0.5, 1.0, 1.5]))   # every step, stacked
    >>> tr, w = walk.generate(torch.Generator().manual_seed(0), obs, (0.0, None), n=4)
    >>> tr.get_choices()[2, "x"], w.shape, tr.inner.get_score().shape
    (tensor(1.5000), torch.Size([4]), torch.Size([3]))
    """

    kernel_gen_fn: GenerativeFunction[tuple[Carry, Y]]
    length: int | None = Pytree.static(default=None)

    # -- GFI -------------------------------------------------------------------

    def simulate(self, rng, args: tuple, n=None) -> ScanTrace[Carry, Y]:
        return self.generate(rng, ChoiceMap.empty(), args, n)[0]

    def _no_steps(self, rng, carry, steps: "_Steps", n) -> Trace:
        """The kernel's trace stacked over zero steps: the kernel runs once
        on zeros, on a scratch generator (the caller's stream is untouched),
        for the structure and record of its trace alone."""
        scratch = torch.Generator(device=rng.device).manual_seed(0)
        tr = self.kernel_gen_fn.simulate(scratch, (carry, steps.template(True)), n)
        return _Buffers(tr, 0).stacked()

    def generate(self, rng, constraint: ChoiceMap, args: tuple, n=None, like=None) -> tuple[ScanTrace[Carry, Y], Weight]:
        carry, xs = args
        if like is None:
            args_plain, args_record = _recorded(args)
            steps = _Steps(xs, self.length)
        else:
            args_plain, args_record = _recorded(args)[0], like.args_batched
            n_carry = n_leaves(carry)
            steps = _Steps(args_plain[1], self.length, like.args_record()[n_carry:])
            if steps.length:
                carry = _carry_like(args_plain[0], _step(like.inner, 0).get_args()[0])
        length = steps.length
        if length == 0:
            # No steps: the carry passes through and the score is 0.
            inner = self._no_steps(rng, carry, steps, n)
            weight = torch.zeros(batch_dims(n), device=rng.device)
            return ScanTrace.build(self, inner, args_plain, args_record, _recorded(carry)[0], 0), weight
        learned = None if like is None else like.inner  # a kernel trace with the settled record
        previous, pending, buffers = None, [], None
        weight = torch.zeros(batch_dims(n), device=rng.device)
        for t in range(length):
            sub = constraint if constraint.static_is_empty() else constraint.get_submap(t)
            if learned is None:
                tr, w = self.kernel_gen_fn.generate(rng, sub, (carry, steps.at(t, True)), n)
                carry = marked_like(tr.get_retval()[0], tr.retval_record()[: n_leaves(tr.get_retval()[0])])
                signature = _signature(tr)
                if signature == previous:
                    learned = tr
                previous = signature
            else:
                tr, w = self.kernel_gen_fn.generate(rng, sub, (carry, steps.at(t)), n, learned)
                carry = tr.get_retval()[0]
            weight = weight + w
            if buffers is None and (learned is not None or t == length - 1):
                # The record has settled (or the steps are over): allocate
                # from this trace and write the steps that waited for it.
                buffers = _Buffers(tr, length)
                for s, early in enumerate(pending):
                    buffers.write(s, early)
                pending = []
            if buffers is None:
                pending.append(tr)
            else:
                buffers.write(t, tr)
        inner = buffers.stacked()
        return ScanTrace.build(self, inner, args_plain, args_record, _recorded(carry)[0], length), weight

    def assess(self, sample: ChoiceMap, args: tuple, n=None, marked: bool = False) -> tuple[Score, Any]:
        carry, xs = args
        steps = _Steps(xs, self.length)
        marks = n is not None
        if steps.length == 0:
            scratch = torch.Generator(device=device_of(*pytree.tree_leaves(args), default="cpu"))
            inner = self._no_steps(scratch, carry, steps, n)
            ys = inner.get_retval()[1]
            record = inner.retval_record()[n_leaves(inner.get_retval()[0]) :]
            score = torch.zeros_like(plain(inner.get_score()).sum(-1))
            if marked:
                return score, (carry, marked_like(ys, record))
            return score, (_recorded(carry)[0], ys)
        total, ys = None, []
        for t in range(steps.length):
            sub = sample if sample.static_is_empty() else sample.get_submap(t)
            score, (carry, y) = self.kernel_gen_fn.assess(sub, (carry, steps.at(t, marks)), n, marks)
            total = score if total is None else total + score
            ys.append(y)
        record = [depth_of(v) for v in pytree.tree_leaves(ys[-1])]
        stacked = _stack([_recorded(y)[0] for y in ys], record)
        if marked:
            return total, (carry, marked_like(stacked, record))
        return total, (_recorded(carry)[0], stacked)

    def project(self, rng, trace: ScanTrace, selection: Selection) -> Weight:
        _check_indexable(selection, "Scan.project")
        total = torch.zeros((), device=rng.device)
        depths = trace.inner.batched_leaves()
        for t in range(trace.scan_length):
            # The step level of the address space, as in `edit_regenerate`.
            sub = selection(t)
            if isinstance(sub, NoneSel):
                continue
            total = total + _step(trace.inner, t, depths).project(rng, sub)
        return total

    # -- edit ------------------------------------------------------------------

    def _rescan_edit(self, rng, trace: ScanTrace, make_request, argdiffs, n):
        """Re-scan the whole sequence, editing each step; the carry chain
        carries edited values forward (a dense recompute)."""
        primals = Diff.tree_primal(argdiffs)
        carry, xs = primals
        n_carry = n_leaves(carry)
        steps = _Steps(xs, self.length, trace.args_record()[n_carry:])
        if steps.length != trace.scan_length:
            raise ValueError("Scan.edit: the number of steps changed")
        depths = trace.inner.batched_leaves()
        buffers, bwds = None, []
        weight = torch.zeros((), device=rng.device)
        for t in range(steps.length):
            old = _step(trace.inner, t, depths)
            if t == 0:
                carry = _carry_like(carry, old.get_args()[0])
            x = steps.at(t)
            # The carry may have changed at any step; the scanned slice keeps
            # the caller's tangents leaf for leaf, so a NoChange data axis
            # keeps the kernel's plan.
            step_diffs = (Diff.unknown_change(carry), rediff(x, argdiffs[1]))
            request = make_request(t)
            if isinstance(request, PrimitiveEditRequest):
                new, w, retdiff, bwd = self.kernel_gen_fn.edit(rng, old, request, step_diffs, n)
            else:
                new, w, retdiff, bwd = request.edit(rng, old, step_diffs)
            carry = Diff.tree_primal(retdiff)[0]
            weight = weight + w
            bwds.append(bwd)
            if buffers is None:
                buffers = _Buffers(new, steps.length)
            buffers.write(t, new)
        # Over zero steps nothing is edited: the empty stack stays.
        inner = trace.inner if buffers is None else buffers.stacked()
        new_trace = ScanTrace.build(self, inner, primals, trace.args_batched, carry, steps.length)
        return new_trace, weight, Diff.unknown_change(new_trace.retval), bwds

    def edit_update(self, rng, trace, constraint: ChoiceMap, argdiffs, n=None):
        empty = constraint.static_is_empty()
        new_trace, w, retdiff, bwds = self._rescan_edit(
            rng, trace, lambda t: Update(constraint if empty else constraint.get_submap(t)), argdiffs, n
        )
        # One `Update` whose constraint's leaves carry the step axis.
        return new_trace, w, retdiff, Update(_stack_discards([b.constraint for b in bwds]))

    def edit_regenerate(self, rng, trace, selection: Selection, argdiffs, n=None):
        _check_indexable(selection, "Scan.edit_regenerate")
        new_trace, w, retdiff, bwds = self._rescan_edit(rng, trace, lambda t: Regenerate(selection(t)), argdiffs, n)
        return new_trace, w, retdiff, VectorRequest(tuple(bwds))

    def _rescan_vector_edit(self, rng, trace, request: VectorRequest, argdiffs, n=None):
        """Apply a vector request: step `t` gets its `t`-th sub-request."""
        if isinstance(request.request, (tuple, list)) and len(request.request) != trace.scan_length:
            raise ValueError("VectorRequest: one sub-request per step")
        new_trace, w, retdiff, bwds = self._rescan_edit(rng, trace, request.at_step, argdiffs, n)
        return new_trace, w, retdiff, VectorRequest(tuple(bwds))

    def edit_index(self, rng, trace: ScanTrace, idx, request: EditRequest, argdiffs, n=None):
        """Edit step `idx`, then revisit step `idx + 1` once to account for
        its changed carry-in: two steps' work, whatever the length (the
        scatter back copies each stacked leaf).

        Sound only where the kernel's carry-out at step `idx + 1` does not
        depend on its carry-in (the carry is drawn afresh at every step,
        as a Markov chain's state is). Inside `do_checkify()` each edit
        verifies it; use the re-scan `Update` / `Regenerate` where unsure."""
        if not Diff.static_check_no_change(argdiffs):
            raise ValueError("Scan.edit_index edits a step under unchanged arguments")
        length = trace.scan_length
        inner, depths = trace.inner, trace.inner.batched_leaves()
        old_c_final = trace.retval[0]
        static_idx = isinstance(idx, int)

        step = _step(inner, idx, depths)
        new_step, w, retdiff, bwd = request.edit(rng, step, Diff.no_change(step.get_args()))
        carry_out = Diff.tree_primal(retdiff)[0]
        new_inner = _put_step(inner, new_step, idx)

        if static_idx:
            nxt, has_next = min(idx + 1, length - 1), idx + 1 < length
        else:
            nxt, has_next = torch.clamp(idx + 1, max=length - 1), idx + 1 < length
        if not static_idx or has_next:
            # Revisit step idx + 1 with the changed carry-in.
            next_step = _step(inner, nxt, depths)
            next_new, next_w, next_retdiff, _ = self.kernel_gen_fn.edit(
                rng,
                next_step,
                Update(ChoiceMap.empty()),
                (Diff.unknown_change(carry_out), Diff.no_change(next_step.get_args()[1])),
                n,
            )
            new_inner = _put_step(new_inner, next_new, nxt, None if static_idx else has_next)
            w = w + (next_w if static_idx else next_w * has_next)
            if should_check():
                self._check_carry(trace, Diff.tree_primal(next_retdiff)[0], nxt, has_next, depths)

        is_last = idx == length - 1
        if static_idx:
            c_final = carry_out if is_last else old_c_final
        else:
            c_final = pytree.tree_map(
                lambda a, b: torch.where(is_last, a, b) if _is_tensor(a) or _is_tensor(b) else b, carry_out, old_c_final
            )
        new_trace = ScanTrace.build(self, new_inner, trace.args, trace.args_batched, c_final, length)
        return new_trace, w, Diff.unknown_change(new_trace.retval), IndexRequest(idx, bwd)

    def _check_carry(self, trace: ScanTrace, next_c_out, nxt, has_next, depths) -> None:
        """The carry out of the revisited step is what it always was:
        otherwise the change would reach step idx + 2 and beyond, which
        the edit does not touch. The old carry-out of step `nxt` is step
        nxt + 1's carry-in, or the final carry."""
        length = trace.scan_length
        nxt, has_next = int(nxt), bool(has_next)
        if not has_next:
            return
        old = trace.retval[0] if nxt + 1 >= length else _step(trace.inner, nxt + 1, depths).get_args()[0]
        for a, b in zip(pytree.tree_leaves(next_c_out), pytree.tree_leaves(old)):
            a, b = torch.as_tensor(a), torch.as_tensor(b).to(torch.as_tensor(a).device)
            if not torch.allclose(a.to(torch.float64), b.to(torch.float64).expand(a.shape), rtol=1e-5, atol=1e-6):
                raise ValueError(
                    "Scan.edit_index: the revisited step's carry-out changed: this kernel's carry depends "
                    "on its carry-in, so the single-step edit would corrupt the steps beyond idx + 1. "
                    "Use the dense re-scan Update / Regenerate edit instead."
                )

    def edit(self, rng, trace: ScanTrace, edit_request: EditRequest, argdiffs, n=None):
        match edit_request:
            case Update(constraint):
                return self.edit_update(rng, trace, constraint, argdiffs, n)
            case Regenerate(selection):
                return self.edit_regenerate(rng, trace, selection, argdiffs, n)
            case IndexRequest(idx, request):
                return self.edit_index(rng, trace, idx, request, argdiffs, n)
            case VectorRequest():
                return self._rescan_vector_edit(rng, trace, edit_request, argdiffs, n)
            case EmptyRequest():
                return edit_request.edit(rng, trace, argdiffs)
            case _:
                raise NotSupportedEditRequest(edit_request)


def _carry_like(carry: Any, stored: Any) -> Any:
    """The initial carry in the shape that the trace stores step 0's
    carry-in: a shared carry whose later values are per particle is stored
    broadcast, and the kernel's record says per particle."""
    leaves, spec = pytree.tree_flatten(carry)
    out = []
    for c, ref in zip(leaves, pytree.tree_leaves(stored)):
        if _is_tensor(ref) and (not _is_tensor(c) or c.shape != ref.shape):
            # A Python number becomes a tensor by a fill on the device: a
            # copy from the host would synchronise with a CUDA device.
            if _is_tensor(c):
                c = c.to(device=ref.device, dtype=ref.dtype)
            else:
                c = torch.full((), c, dtype=ref.dtype, device=ref.device)
            c = c.expand(ref.shape)
        out.append(c)
    return pytree.tree_unflatten(out, spec)


def _stack_discards(discards: list) -> ChoiceMap:
    """The per-step discards of a re-scan `Update` as one choice map:
    stacked along the step axis where every step discarded the same
    addresses, else each step's nested under its index."""
    if all(d.static_is_empty() for d in discards):
        return ChoiceMap.empty()
    specs = {str(pytree.tree_flatten(d)[1]) for d in discards}
    if len(specs) == 1:
        return _stack(discards, discards[-1].batched_leaves())
    out = ChoiceMap.empty()
    for t, d in enumerate(discards):
        out = out | d.extend(t)
    return out


def scan(*, n: int | None = None):
    """Decorator: wrap a `(c, a) -> (c, b)` function into `(c, [a]) -> (c, [b])`."""

    def decorator(f: GenerativeFunction[tuple[Carry, Y]]) -> Scan[Carry, Y]:
        return Scan(f, n)

    return decorator


###########################
# Derived scan decorators #
###########################


def prepend_initial_acc(args, ret):
    """Prepend the initial accumulator to the scan's outputs, along their
    step axis (right behind the batch axes that their marks record: a
    `Dimap` hands its mappings marked values)."""

    def prepend(init, acc):
        d = depth_of(acc)
        acc = plain(acc)
        first = torch.as_tensor(plain(init), dtype=acc.dtype, device=acc.device)
        first = first.expand(acc.shape[:d] + acc.shape[d + 1 :]).unsqueeze(d)
        return mark(torch.cat([first, acc], dim=d), d)

    return pytree.tree_map(prepend, args[0], ret[1])


def accumulate():
    """`(c, a) -> c` kernel becomes `(c, [a]) -> [c]`: every intermediate
    accumulation, with the initial value prepended."""

    def decorator(f: GenerativeFunction[Carry]):
        kernel = Dimap(f, lambda c, x: (c, x), lambda _args, _xformed, c: (c, c), "accumulate-kernel")
        return Dimap(
            Scan(kernel, None),
            lambda *args: args,
            lambda args, _xformed, ret: prepend_initial_acc(args, ret),
            "accumulate",
        )

    return decorator


def reduce():
    """`(c, a) -> c` kernel becomes `(c, [a]) -> c` (the final accumulation)."""

    def decorator(f: GenerativeFunction[Carry]):
        kernel = Dimap(f, lambda c, x: (c, x), lambda _args, _xformed, c: (c, None), "reduce-kernel")
        return Dimap(Scan(kernel, None), lambda *args: args, lambda _args, _xformed, ret: ret[0], "reduce")

    return decorator


def iterate(*, n: int):
    """`a -> a` kernel becomes `a -> [a]`: all `n + 1` iterates, the
    initial value included."""

    def decorator(f: GenerativeFunction[Any]):
        kernel = Dimap(f, lambda c, _scanned: (c,), lambda _args, _xformed, c: (c, c), "iterate-kernel")
        return Dimap(
            Scan(kernel, n),
            lambda a: (a, None),
            lambda args, _xformed, ret: prepend_initial_acc(args, ret),
            "iterate",
        )

    return decorator


def iterate_final(*, n: int):
    """`a -> a` kernel becomes `a -> a`: apply `n` times, the final value."""

    def decorator(f: GenerativeFunction[Any]):
        kernel = Dimap(f, lambda c, _scanned: (c,), lambda _args, _xformed, c: (c, None), "iterate-final-kernel")
        return Dimap(Scan(kernel, n), lambda a: (a, None), lambda _args, _xformed, ret: ret[0], "iterate_final")

    return decorator


def masked_iterate():
    """`a -> a` kernel becomes `(a, [flags]) -> [a]`: step `t` runs the
    kernel under `MaskCombinator` with flag `t`; a masked-out step still
    hands its value on but adds nothing to the score (sequences of varying
    length)."""

    def decorator(f: GenerativeFunction[Any]):
        from genjax_tpu_torch.combinators.mask import MaskCombinator

        kernel = Dimap(
            MaskCombinator(f),
            lambda c, flag: (flag, c),
            lambda _args, _xformed, masked: (masked.value, masked.value),
            "masked-iterate-kernel",
        )
        return Dimap(
            Scan(kernel, None),
            lambda *args: args,
            lambda args, _xformed, ret: prepend_initial_acc(args, ret),
            "masked_iterate",
        )

    return decorator


def masked_iterate_final():
    """`a -> a` kernel becomes `(a, [flags]) -> a` (the final value)."""

    def decorator(f: GenerativeFunction[Any]):
        from genjax_tpu_torch.combinators.mask import MaskCombinator

        kernel = Dimap(
            MaskCombinator(f),
            lambda c, flag: (flag, c),
            lambda _args, _xformed, masked: (masked.value, None),
            "masked-iterate-final-kernel",
        )
        return Dimap(Scan(kernel, None), lambda *args: args, lambda _args, _xformed, ret: ret[0], "masked_iterate_final")

    return decorator
