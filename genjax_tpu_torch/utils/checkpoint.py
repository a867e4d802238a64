"""Checkpoint and resume of inference state.

Counterpart of `genjax_tpu/utils/checkpoint.py`, on `torch.save` /
`torch.load` (JAX's uses orbax). Every piece of inference state (a trace,
a `ParticleCollection`, chain states, variational parameters) is a pytree,
and a run resumes bit for bit from its tensors and its generators' states.
So a checkpoint holds no pickled object: `save_checkpoint` writes the flat
list of the state's leaves, each a tensor, a generator's state (for a CUDA
generator its Philox seed and offset) or a Python number, and
`torch.load(weights_only=True)` reads it back. `restore_checkpoint` puts
them back into the structure of `target`, a state of the same shape (a
fresh run's, or the live one): it checks the count of leaves and each
tensor's shape and dtype against the target's, raises on a mismatch, and
places each tensor on its target leaf's device and each generator state
into a new generator on the target generator's device.

>>> import os, tempfile, torch
>>> from genjax_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
>>> rng = torch.Generator().manual_seed(3)
>>> state = {"w": torch.randn(4, generator=rng), "rng": rng}
>>> path = os.path.join(tempfile.mkdtemp(), "state.pt")
>>> save_checkpoint(path, state)
>>> back = restore_checkpoint(path, {"w": torch.zeros(4), "rng": torch.Generator()})
>>> torch.equal(back["w"], state["w"]), torch.equal(torch.rand(2, generator=back["rng"]), torch.rand(2, generator=rng))
(True, True)
"""

from typing import Any

import torch
import torch.utils._pytree as pytree

from genjax_tpu_torch.core.typing import plain

_FORMAT = "genjax_tpu_torch.checkpoint/1"
_VALUES = (bool, int, float, str, type(None))


def save_checkpoint(path: str, state: Any) -> None:
    """Write the leaves of `state` (a trace, a `ParticleCollection`, a
    dict of those and generators, ...) to `path`."""
    leaves = []
    for leaf in pytree.tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            leaves.append(plain(leaf).detach())
        elif isinstance(leaf, torch.Generator):
            leaves.append({"generator_state": leaf.get_state(), "device": leaf.device.type})
        elif isinstance(leaf, _VALUES):
            leaves.append({"value": leaf})
        else:
            raise TypeError(f"save_checkpoint: a leaf of type {type(leaf).__name__} is no tensor, generator or number")
    torch.save({"format": _FORMAT, "leaves": leaves}, path)


def restore_checkpoint(path: str, target: Any) -> Any:
    """The state saved at `path`, in the structure of `target` (a pytree
    of the same structure, whose leaves give each tensor's shape, dtype
    and device)."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(saved, dict) or saved.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a checkpoint written by save_checkpoint")
    leaves, spec = pytree.tree_flatten(target)
    stored = saved["leaves"]
    if len(stored) != len(leaves):
        raise ValueError(f"{path}: {len(stored)} leaves saved, the target has {len(leaves)}")
    out = []
    for i, (want, got) in enumerate(zip(leaves, stored)):
        if isinstance(want, torch.Tensor):
            if not isinstance(got, torch.Tensor) or got.shape != want.shape or got.dtype != want.dtype:
                what = f"{tuple(got.shape)} {got.dtype}" if isinstance(got, torch.Tensor) else type(got).__name__
                raise ValueError(f"leaf {i}: saved {what}, the target has {tuple(want.shape)} {want.dtype}")
            out.append(got.to(want.device))
        elif isinstance(want, torch.Generator):
            if not isinstance(got, dict) or got.get("device") != want.device.type:
                raise ValueError(f"leaf {i}: the target holds a generator on {want.device}, the checkpoint {got!r}")
            rng = torch.Generator(device=want.device)
            rng.set_state(got["generator_state"])
            out.append(rng)
        else:
            if not isinstance(got, dict) or "value" not in got or type(got["value"]) is not type(want):
                raise ValueError(f"leaf {i}: the target holds {want!r}, the checkpoint {got!r}")
            out.append(got["value"])
    return pytree.tree_unflatten(out, spec)
