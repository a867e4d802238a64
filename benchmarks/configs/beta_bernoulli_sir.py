"""The beta-bernoulli SIR trial on the program under test.

One call is one trial, as a user runs it: `ImportanceK` over K particles
(`run_smc`), the log marginal likelihood estimate, and one particle drawn
in proportion to its weight; the call ends when the host holds the LML.
"""

import torch


class Program:
    def __init__(self, config: dict, traffic: dict, inputs: dict, seed: int, device):
        from genjax_tpu_torch import ChoiceMap, ImportanceK, Target
        from genjax_tpu_torch.models.beta_bernoulli import beta_bernoulli

        self.rng = torch.Generator(device=device).manual_seed(seed)
        target = Target(beta_bernoulli, (config["alpha"], config["beta"]), ChoiceMap.d({"v": inputs["observed"]}))
        self.alg = ImportanceK(target, k_particles=traffic["particles"])

    def call(self, i: int):
        col = self.alg.run_smc(self.rng)
        lml = col.get_log_marginal_likelihood_estimate()
        drawn = col.sample_particle(self.rng)
        return (col, lml, drawn), float(lml)

    def small(self, out):
        """What every call keeps inside the window besides its LML: the drawn
        particle's `p`, the value a user reads (a 0-d copy on the device)."""
        return out[2].get_choices()["p"]

    def record(self, out):
        """A kept call's outputs, for the judge."""
        col, lml, drawn = out
        particles = col.get_particles()
        return {
            "p": particles.get_choices()["p"],
            "weight": col.get_log_weights(),
            "score": particles.get_score(),
            "lml": lml,
            "drawn_p": drawn.get_choices()["p"],
            "drawn_score": drawn.get_score(),
        }
