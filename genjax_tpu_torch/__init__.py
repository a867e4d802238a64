"""genjax_tpu_torch: the particle, SMC, MCMC, combinator, branching and
ADEV/VI paths of genjax_tpu on PyTorch and CUDA.

A port of `genjax_tpu` (JAX) to PyTorch, module for module
(`genjax_tpu_torch/inference/smc.py` mirrors `genjax_tpu/inference/smc.py`).
Randomness comes from explicit `torch.Generator`s; batching over particles
is a leading tensor axis (`n=` on the GFI methods), and a `vmap` adds a
lane axis behind it; kernels are written by
hand in CUDA under `csrc/` and built at first use. ADEV (`adev/`) runs a
loss eagerly under a handler, each estimate a tensor whose autograd
gradient is the gradient estimate, multi-call strategies re-executing the
loss (`adev/core.py`); variational inference (`inference/vi.py`), nested
sampling (`inference/nested.py`) and BASELINE config 5
(`models/ravi.py`) sit on it. This package imports torch and numpy, never
jax.
"""

from genjax_tpu_torch.combinators import (
    Dimap,
    MaskCombinator,
    RepeatCombinator,
    Scan,
    Switch,
    VectorRequest,
    Vmap,
    accumulate,
    contramap,
    dimap,
    iterate,
    iterate_final,
    map,
    mask,
    masked_iterate,
    masked_iterate_final,
    mix,
    or_else,
    reduce,
    repeat,
    scan,
    switch,
    vmap,
)
from genjax_tpu_torch.core.choice_map import ChoiceMap, ChoiceMapBuilder, Selection
from genjax_tpu_torch.core.concepts import IndexRequest
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu_torch.core.mask import Mask
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.core.requests import EmptyRequest, Regenerate, UnsupportedBackwardRequest
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.distributions import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
    bernoulli,
    beta,
    categorical,
    dirichlet,
    flip,
    forward_filtering_backward_sampling,
    gamma,
    geometric,
    mv_normal_diag,
    normal,
    uniform,
)
from genjax_tpu_torch import adev, inference
from genjax_tpu_torch.inference import (
    HMC,
    MALA,
    Algorithm,
    BootstrapFilter,
    ImportanceK,
    JumpProposal,
    Marginal,
    ParticleCollection,
    SampleDistribution,
    Target,
    enumerative_gibbs,
    ess,
    gibbs_chain,
    gibbs_sweep,
    marginal,
    mh,
    mh_chain,
    requests,
    reversible_jump,
    run_chains,
    smc,
    vi,
)
from genjax_tpu_torch.lang import AddressReuse, MissingAddress, gen
from genjax_tpu_torch.ops import logsumexp

__all__ = [
    "AddressReuse",
    "Algorithm",
    "BootstrapFilter",
    "ChoiceMap",
    "ChoiceMapBuilder",
    "Diff",
    "Dimap",
    "DiscreteHMM",
    "DiscreteHMMConfiguration",
    "EmptyRequest",
    "GenerativeFunction",
    "HMC",
    "ImportanceK",
    "IndexRequest",
    "JumpProposal",
    "MALA",
    "Marginal",
    "Mask",
    "MaskCombinator",
    "MissingAddress",
    "ParticleCollection",
    "Pytree",
    "Regenerate",
    "RepeatCombinator",
    "SampleDistribution",
    "Scan",
    "Selection",
    "Switch",
    "Target",
    "Trace",
    "UnsupportedBackwardRequest",
    "Update",
    "VectorRequest",
    "Vmap",
    "accumulate",
    "adev",
    "bernoulli",
    "beta",
    "categorical",
    "contramap",
    "dimap",
    "dirichlet",
    "enumerative_gibbs",
    "ess",
    "flip",
    "forward_filtering_backward_sampling",
    "gamma",
    "gen",
    "geometric",
    "gibbs_chain",
    "gibbs_sweep",
    "iterate",
    "inference",
    "iterate_final",
    "logsumexp",
    "map",
    "marginal",
    "mask",
    "masked_iterate",
    "masked_iterate_final",
    "mh",
    "mh_chain",
    "mix",
    "mv_normal_diag",
    "normal",
    "or_else",
    "per_particle",
    "reduce",
    "repeat",
    "requests",
    "reversible_jump",
    "run_chains",
    "scan",
    "smc",
    "switch",
    "uniform",
    "vi",
    "vmap",
]
