"""genjax_tpu_torch: the particle path of genjax_tpu on PyTorch and CUDA.

A port of `genjax_tpu` (JAX) to PyTorch, module for module
(`genjax_tpu_torch/inference/smc.py` mirrors `genjax_tpu/inference/smc.py`).
Randomness comes from explicit `torch.Generator`s; batching over particles
is a leading tensor axis (`n=` on the GFI methods); kernels are written by
hand in CUDA under `csrc/` and built at first use. This package imports
torch and numpy, never jax.
"""

from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.distributions import beta, flip, normal, uniform
from genjax_tpu_torch.inference import (
    BootstrapFilter,
    ImportanceK,
    ParticleCollection,
    Target,
    ess,
)
from genjax_tpu_torch.lang import AddressReuse, MissingAddress, gen
from genjax_tpu_torch.ops import logsumexp

__all__ = [
    "AddressReuse",
    "BootstrapFilter",
    "ChoiceMap",
    "GenerativeFunction",
    "ImportanceK",
    "MissingAddress",
    "ParticleCollection",
    "Pytree",
    "Selection",
    "Target",
    "Trace",
    "beta",
    "ess",
    "flip",
    "gen",
    "logsumexp",
    "normal",
    "uniform",
]
