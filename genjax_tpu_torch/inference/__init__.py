from genjax_tpu_torch.inference import (
    mcmc,
    particle_filter,
    particle_gibbs,
    pmmh,
    requests,
    rjmcmc,
    smc,
    smoothing,
    tempered,
)
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
from genjax_tpu_torch.inference.requests import HMC, MALA, GaussianDrift, Rejuvenate
from genjax_tpu_torch.inference.rjmcmc import JumpProposal, reversible_jump
from genjax_tpu_torch.inference.smc import (
    ChangeTarget,
    Importance,
    ImportanceK,
    ParticleCollection,
    SMCDriver,
    ess,
)
from genjax_tpu_torch.inference.sp import Algorithm, Marginal, SampleDistribution, Target, marginal

__all__ = [
    "HMC",
    "MALA",
    "Algorithm",
    "BootstrapFilter",
    "ChangeTarget",
    "GaussianDrift",
    "Importance",
    "ImportanceK",
    "JumpProposal",
    "Marginal",
    "ParticleCollection",
    "Rejuvenate",
    "SMCDriver",
    "SampleDistribution",
    "Target",
    "enumerative_gibbs",
    "ess",
    "gibbs_chain",
    "gibbs_sweep",
    "marginal",
    "mcmc",
    "mh",
    "mh_chain",
    "particle_filter",
    "particle_gibbs",
    "pmmh",
    "requests",
    "reversible_jump",
    "rjmcmc",
    "run_chains",
    "share_chain_args",
    "smc",
    "smoothing",
    "tempered",
]
