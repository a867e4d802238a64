"""The collectives of the parallel layer, each on a named mesh axis, with
a record of calls and bytes per axis.

The port's counterpart of the compiled-HLO checks of JAX's parallel tests
(`tests/parallel/test_hlo_collectives.py`, `test_hlo_island_collectives.py`):
JAX reads the collectives off the compiled program, the port counts them
where they run. `stats()` gives, per mesh axis, the calls and bytes of each
kind since import (or `reset_stats()`):

- `all_reduce` (sum or max): the bytes of the reduced tensor;
- `all_gather` (along the leading axis, into one tensor): the bytes of the
  gathered tensor;
- `exchange` (the neighbour exchange of resampling, one
  `dist.batch_isend_irecv` of a send to and a receive from each
  neighbour): the bytes received;
- `broadcast` from the axis's first rank: the bytes of the tensor;
- `staged`: the bytes of the exchange copied through pinned host memory,
  below.

Every call names its process group (`Mesh.group(axis)`); none uses the
default group implicitly.

The gather is `dist.all_gather_into_tensor`: it exists in torch 2.11 and
2.13; 2.13 deprecates it in favour of `all_gather_single`, which 2.11
lacks, and its deprecation warning is silenced here. A gloo group takes
CUDA tensors in its collectives, but its point-to-point transport aborts
the process on one (torch 2.11: `gloo::IoException ... writev ... Bad
address`, the socket handed a device pointer), so on a gloo group the
exchange's CUDA buffers go through pinned host memory, explicitly, and
the copies are counted under `staged`. An NCCL group never stages.
"""

import warnings
from collections import defaultdict

import torch
import torch.distributed as dist

from genjax_tpu_torch.parallel.mesh import Mesh

KINDS = ("all_reduce", "all_gather", "exchange", "broadcast", "staged")

_STATS: dict = defaultdict(lambda: {k: [0, 0] for k in KINDS})


def stats() -> dict:
    """`{axis: {kind: {"calls": n, "bytes": b}}}` since import or the last
    `reset_stats()`; axes with no call are absent."""
    return {axis: {k: {"calls": c, "bytes": b} for k, (c, b) in kinds.items()} for axis, kinds in _STATS.items()}


def reset_stats() -> None:
    _STATS.clear()


def _count(axis: str, kind: str, nbytes: int) -> None:
    entry = _STATS[axis][kind]
    entry[0] += 1
    entry[1] += nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_host(t: torch.Tensor, axis: str) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    _count(axis, "staged", _nbytes(t))
    return host


def _from_host(dst: torch.Tensor, host: torch.Tensor, axis: str) -> torch.Tensor:
    dst.copy_(host)
    _count(axis, "staged", _nbytes(host))
    return dst


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """Reduce `t` (`op` "sum" or "max") over the ranks along `axis`, in
    place; returns `t`, the same on every rank of the axis."""
    _count(axis, "all_reduce", _nbytes(t))
    dist.all_reduce(t, _OPS[op], group=mesh.group(axis))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ranks' `t` along `axis`, concatenated in rank order along the
    leading axis (JAX's `all_gather(..., tiled=True)`)."""
    t = t.contiguous()
    out = torch.empty((mesh.shape[axis] * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    _count(axis, "all_gather", _nbytes(out))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=mesh.group(axis))
    return out


def exchange(buffers: list[torch.Tensor], mesh: Mesh, axis: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Send each buffer to both neighbours along `axis` (a ring) and
    receive theirs: `[(from_left, from_right), ...]`, one pair per buffer,
    where the left neighbour is the rank one below along the axis.

    All sends and receives go in one `batch_isend_irecv`. Two ranks are
    each other's left and right neighbour, so the two messages to one peer
    carry tags (rightward `2 i`, leftward `2 i + 1`) and are posted in the
    same order on both sides, which matches them on a group that ignores
    tags (NCCL matches the messages of one peer in order)."""
    group = mesh.group(axis)
    n, r = mesh.shape[axis], mesh.rank(axis)
    left, right = dist.get_global_rank(group, (r - 1) % n), dist.get_global_rank(group, (r + 1) % n)
    staged = bool(buffers) and buffers[0].is_cuda and mesh.backend(axis) == "gloo"
    sends = [_to_host(b.contiguous(), axis) if staged else b.contiguous() for b in buffers]
    recvs = [(torch.empty_like(s), torch.empty_like(s)) for s in sends]
    ops = []
    for i, (s, (from_left, from_right)) in enumerate(zip(sends, recvs)):
        ops += [
            dist.P2POp(dist.isend, s, right, group, 2 * i),
            dist.P2POp(dist.isend, s, left, group, 2 * i + 1),
            dist.P2POp(dist.irecv, from_left, left, group, 2 * i),
            dist.P2POp(dist.irecv, from_right, right, group, 2 * i + 1),
        ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count(axis, "exchange", sum(2 * _nbytes(s) for s in sends))
    if staged:
        recvs = [tuple(_from_host(torch.empty_like(b), h, axis) for h in pair) for b, pair in zip(buffers, recvs)]
    return recvs


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """`t` of the first rank along `axis`, written into `t` on every rank
    of the axis; returns `t`."""
    group = mesh.group(axis)
    _count(axis, "broadcast", _nbytes(t))
    dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
    return t


__all__ = ["KINDS", "all_gather", "all_reduce", "broadcast", "exchange", "reset_stats", "stats"]
