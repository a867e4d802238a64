"""genjax_tpu_torch: the particle, SMC, MCMC, combinator, branching and
ADEV/VI paths of genjax_tpu on PyTorch and CUDA, with its whole
distribution library.

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
(`models/ravi.py`) sit on it; the adaptive samplers (NUTS, ChEES, warmup
adaptation, elliptical slice, `inference/sample.py::sample_posterior`)
and the checks built on them (diagnostics, PSIS, SBC/Geweke, Kalman,
MAP/Laplace) sit on the MCMC drivers. This package imports torch and
numpy, never jax.

The public API is checked at every call, as JAX's is once per trace
(`core/typecheck.py`, on by default; `do_typecheck(False)` takes the
wrappers off, `checked_mode()` adds the deeper checks of
`core/checked.py`). `utils/` holds the time-travel debugger, checkpoints
(`torch.save` of the state's tensor leaves and generator states),
`torch.profiler` spans and traces, and operation counts.
"""

from genjax_tpu_torch import adev, inference
from genjax_tpu_torch.combinators import *  # noqa: F401,F403
from genjax_tpu_torch.combinators import __all__ as _cmb_all
from genjax_tpu_torch.core import *  # noqa: F401,F403
from genjax_tpu_torch.core import __all__ as _core_all
from genjax_tpu_torch.core.requests import UnsupportedBackwardRequest
from genjax_tpu_torch.core.typing import per_particle
from genjax_tpu_torch.distributions import *  # noqa: F401,F403
from genjax_tpu_torch.distributions import __all__ as _dist_all
from genjax_tpu_torch.inference import (
    HMC,
    MALA,
    NUTS,
    Algorithm,
    BootstrapFilter,
    EllipticalSlice,
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
from genjax_tpu_torch.lang import *  # noqa: F401,F403
from genjax_tpu_torch.lang import __all__ as _lang_all
from genjax_tpu_torch.ops import logsumexp
from genjax_tpu_torch.utils.pretty import pretty
from genjax_tpu_torch.utils.time_travel import rec, tag, time_machine

__all__ = [  # noqa: PLE0604
    *_core_all,
    *_dist_all,
    *_lang_all,
    *_cmb_all,
    "Algorithm",
    "BootstrapFilter",
    "EllipticalSlice",
    "HMC",
    "ImportanceK",
    "JumpProposal",
    "MALA",
    "Marginal",
    "NUTS",
    "ParticleCollection",
    "SampleDistribution",
    "Target",
    "UnsupportedBackwardRequest",
    "adev",
    "enumerative_gibbs",
    "ess",
    "gibbs_chain",
    "gibbs_sweep",
    "inference",
    "logsumexp",
    "marginal",
    "mh",
    "mh_chain",
    "per_particle",
    "pretty",
    "rec",
    "requests",
    "reversible_jump",
    "run_chains",
    "smc",
    "tag",
    "time_machine",
    "vi",
]

# The public API's argument checks, on by default as JAX's are
# (`core/typecheck.py`; `do_typecheck(False)` takes them off).
import sys as _sys  # noqa: E402

from genjax_tpu_torch.core import typecheck as _typecheck  # noqa: E402

_typecheck.instrument(_sys.modules[__name__])
