"""The bootstrap particle filter of the nonlinear state-space model on the
program under test.

The filter is built once, as `models/ssm.py::run_bootstrap_filter` builds
it (`make_ssm_models`, then `BootstrapFilter` with the configured
resampler and ESS gate); one call filters one observation sequence, the
calls taking the run's sequences in turn, and ends when the host holds the
LML.

The filter returns no count of its resamples, so each call counts the row
copies (`particle_filter._take_rows`) it makes: one per firing of the ESS
gate, and the final one.
"""

import torch


class Program:
    def __init__(self, config: dict, traffic: dict, inputs: dict, seed: int, device):
        from genjax_tpu_torch.inference import particle_filter
        from genjax_tpu_torch.inference.particle_filter import BootstrapFilter
        from genjax_tpu_torch.models.ssm import make_ssm_models

        if config["sin_coef"] != 0.5 or config["init_scale"] != 1.0:
            raise ValueError("models/ssm.py fixes the sine coefficient at 0.5 and the initial scale at 1")
        init_model, step_model = make_ssm_models(config["trans_coef"], config["trans_noise"], config["obs_noise"])
        self.filter = BootstrapFilter(
            step_model, init_model, traffic["particles"], obs_addr="y",
            resampling=config["resampling"], ess_threshold=config["ess_threshold"],
        )
        self.ys = inputs["observations"]
        self.rng = torch.Generator(device=device).manual_seed(seed)
        self.module, self.take_rows = particle_filter, particle_filter._take_rows
        self.copies = 0

    def counted_take_rows(self, z, idx):
        self.copies += 1
        return self.take_rows(z, idx)

    def call(self, i: int):
        d = i % self.ys.shape[0]
        self.copies = 0
        self.module._take_rows = self.counted_take_rows
        try:
            lml, states = self.filter.run(self.rng, self.ys[d])
        finally:
            self.module._take_rows = self.take_rows
        return (d, lml, states, self.copies - 1), float(lml)

    def small(self, out):
        """What every call keeps inside the window: its sequence and the
        number of times its ESS gate fired."""
        return out[0], out[3]

    def record(self, out):
        d, lml, states, _ = out
        return {"dataset": d, "lml": lml, "states": states}
