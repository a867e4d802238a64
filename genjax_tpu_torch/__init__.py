"""genjax_tpu_torch: the particle, MCMC and combinator paths of genjax_tpu
on PyTorch and CUDA.

A port of `genjax_tpu` (JAX) to PyTorch, module for module
(`genjax_tpu_torch/inference/smc.py` mirrors `genjax_tpu/inference/smc.py`).
Randomness comes from explicit `torch.Generator`s; batching over particles
is a leading tensor axis (`n=` on the GFI methods), and a `vmap` adds a
lane axis behind it; kernels are written by
hand in CUDA under `csrc/` and built at first use. This package imports
torch and numpy, never jax.
"""

from genjax_tpu_torch.combinators import (
    Dimap,
    RepeatCombinator,
    Scan,
    VectorRequest,
    Vmap,
    accumulate,
    contramap,
    dimap,
    iterate,
    iterate_final,
    map,
    reduce,
    repeat,
    scan,
    vmap,
)
from genjax_tpu_torch.core.choice_map import ChoiceMap, Selection
from genjax_tpu_torch.core.concepts import IndexRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.requests import EmptyRequest, Regenerate
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.distributions import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
    bernoulli,
    beta,
    categorical,
    flip,
    forward_filtering_backward_sampling,
    mv_normal_diag,
    normal,
    uniform,
)
from genjax_tpu_torch.inference import (
    HMC,
    MALA,
    BootstrapFilter,
    ImportanceK,
    ParticleCollection,
    Target,
    ess,
    mh,
    mh_chain,
    run_chains,
)
from genjax_tpu_torch.lang import AddressReuse, MissingAddress, gen
from genjax_tpu_torch.ops import logsumexp

__all__ = [
    "AddressReuse",
    "BootstrapFilter",
    "ChoiceMap",
    "Diff",
    "Dimap",
    "DiscreteHMM",
    "DiscreteHMMConfiguration",
    "EmptyRequest",
    "GenerativeFunction",
    "HMC",
    "ImportanceK",
    "IndexRequest",
    "MALA",
    "MissingAddress",
    "ParticleCollection",
    "Pytree",
    "Regenerate",
    "RepeatCombinator",
    "Scan",
    "Selection",
    "Target",
    "Trace",
    "Update",
    "VectorRequest",
    "Vmap",
    "accumulate",
    "bernoulli",
    "beta",
    "categorical",
    "contramap",
    "dimap",
    "ess",
    "flip",
    "forward_filtering_backward_sampling",
    "gen",
    "iterate",
    "iterate_final",
    "logsumexp",
    "map",
    "mh",
    "mh_chain",
    "mv_normal_diag",
    "normal",
    "per_particle",
    "reduce",
    "repeat",
    "run_chains",
    "scan",
    "uniform",
    "vmap",
]
