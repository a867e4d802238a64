from genjax_tpu_torch.inference.particle_filter import BootstrapFilter
from genjax_tpu_torch.inference.smc import ImportanceK, ParticleCollection, ess
from genjax_tpu_torch.inference.sp import Algorithm, Target

__all__ = [
    "Algorithm",
    "BootstrapFilter",
    "ImportanceK",
    "ParticleCollection",
    "Target",
    "ess",
]
