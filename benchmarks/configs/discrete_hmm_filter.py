"""The bootstrap particle filter of the 64-state discrete HMM on the
program under test.

The filter is built once through `models/hmm.py::hmm_filter` on the
configuration's tables (`DiscreteHMMConfiguration`), from its first state,
with its resampler and ESS gate; one call filters one observation sequence
with `BootstrapFilter.run`, the calls taking the run's sequences in turn,
and ends when the host holds the LML. Each call's gate firings are the
change of the program's `particle_filter.filter_stats["resamples"]` over
the call.
"""

import torch


class Program:
    def __init__(self, config: dict, traffic: dict, inputs: dict, seed: int, device):
        from genjax_tpu_torch.distributions.discrete_hmm import DiscreteHMMConfiguration
        from genjax_tpu_torch.inference import particle_filter
        from genjax_tpu_torch.models.hmm import hmm_filter

        if config["dtype"] != "float32":
            raise ValueError("DiscreteHMMConfiguration makes its tables in float32")
        if config["ess_threshold"] != 0.5:
            raise ValueError("models/hmm.py::hmm_filter fixes the ESS gate at half the particles")
        hmm = DiscreteHMMConfiguration(
            config["n_states"], config["adjacency_trans"], config["adjacency_obs"],
            config["sigma_trans"], config["sigma_obs"],
        )
        self.filter = hmm_filter(hmm, config["initial_state"], traffic["particles"], config["resampling"], device)
        self.ys = inputs["observations"]
        self.rng = torch.Generator(device=device).manual_seed(seed)
        self.stats = particle_filter.filter_stats

    def call(self, i: int):
        d = i % self.ys.shape[0]
        before = self.stats["resamples"]
        lml, states = self.filter.run(self.rng, self.ys[d])
        return (d, lml, states, self.stats["resamples"] - before), float(lml)

    def small(self, out):
        """What every call keeps inside the window: its sequence and the
        number of times its ESS gate fired."""
        return out[0], out[3]

    def record(self, out):
        d, lml, states, _ = out
        return {"dataset": d, "lml": lml, "states": states}
