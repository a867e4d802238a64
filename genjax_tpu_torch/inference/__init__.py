from genjax_tpu_torch.inference.mcmc import (
    enumerative_gibbs,
    gibbs_chain,
    gibbs_sweep,
    mh,
    mh_chain,
    run_chains,
    share_chain_args,
)
from genjax_tpu_torch.inference.particle_filter import BootstrapFilter
from genjax_tpu_torch.inference.requests import HMC, MALA
from genjax_tpu_torch.inference.rjmcmc import JumpProposal, reversible_jump
from genjax_tpu_torch.inference.smc import ImportanceK, ParticleCollection, ess
from genjax_tpu_torch.inference.sp import Algorithm, Target

__all__ = [
    "HMC",
    "MALA",
    "Algorithm",
    "BootstrapFilter",
    "ImportanceK",
    "JumpProposal",
    "ParticleCollection",
    "Target",
    "enumerative_gibbs",
    "ess",
    "gibbs_chain",
    "gibbs_sweep",
    "mh",
    "mh_chain",
    "reversible_jump",
    "run_chains",
    "share_chain_args",
]
