"""The driver entry points: `entry()`, the flagship forward step (one
bootstrap-particle-filter sweep over the nonlinear SSM at K=4096 particles
and T=20 steps), and `dryrun_multichip(n_ranks)`, one full sharded
inference step on `n_ranks` ranks with every driver's numbers certified.

Counterparts of `__graft_entry__.py::entry` and `::dryrun_multichip`. The
observations of `entry()` are simulated from a CPU generator seeded with 1
and then moved to `device`, so the filter sees the same data on every
device.
"""

import torch

from genjax_tpu_torch.models.ssm import run_bootstrap_filter, simulate_ssm_data

N_PARTICLES = 4096
N_STEPS = 20


def entry(device: torch.device | str = "cuda"):
    """Returns (fn, example_args): `fn(rng)` filters the observations and
    returns (LML estimate, mean of the final states). Runs on the CUDA card
    unless `device` says otherwise; without a card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(): no CUDA device; pass device='cpu' to run on the CPU.")
    _, ys = simulate_ssm_data(torch.Generator().manual_seed(1), N_STEPS)
    ys = ys.to(device)

    def fn(rng: torch.Generator):
        lml, z_final = run_bootstrap_filter(rng, ys, n_particles=N_PARTICLES)
        return lml, z_final.mean()

    return fn, (torch.Generator(device=device).manual_seed(0),)


def dryrun_multichip(n_ranks: int, device: str = "cuda", timeout: float = 600.0) -> list:
    """Spawn `n_ranks` ranks and run one full sharded inference step on
    them (`parallel/certify.py::dryrun_rank_body`): ShardedSMC (init, LML,
    ESS, the distributed systematic resample over the neighbour exchange,
    rejuvenation; degenerate weights and the all-gather fallback), the MH
    chains, the 2-D GridSMC and island SMC over a hybrid mesh (on an even
    number of ranks), SVGD, tempered SMC and parallel tempering, each
    certified against the stitched dense run from the same generators (bit
    for bit where the arithmetic is the same) or the conjugate oracle; then
    JAX's GSPMD sections: `warmup_chains` and `chees_warmup` over the chain
    axis against the stitched dense warmup (eps, T and the inverse mass
    within 1e-5 relative, JAX's rule; the printed line says whether they are
    equal bit for bit), and HMC on logistic regression with its data split
    over the ranks against the dense model (`parallel/data.py`).

    The ranks talk over NCCL when each has its own card, over gloo when
    they share a card (NCCL puts one rank on a card) or run on the CPU.
    Returns each rank's numbers and its collectives' record; raises if a
    check fails."""
    import torch

    from genjax_tpu_torch.parallel.certify import dryrun_rank_body
    from genjax_tpu_torch.parallel.launch import launch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(): no CUDA device; pass device='cpu' to run on the CPU.")
    backend = "nccl" if device == "cuda" and n_ranks <= torch.cuda.device_count() else "gloo"
    results = launch(dryrun_rank_body, n_ranks, backend=backend, device=device, timeout=timeout, args=(device,))
    head = results[0]
    extra = "".join(f"; {name} certified" for name in head["stats"])
    bitwise = ", ".join(f"{name} {'bit for bit' if same else 'within 1e-5'}" for name, same in head["bitwise"].items())
    print(f"dryrun_multichip({n_ranks}, {device}, {backend}): sharded SMC lml={head['lml']:.4f} ess={head['ess']:.1f}"
          f" posterior mean {head['posterior_mean']:.4f}{extra}; the warmups against the stitched dense ones: {bitwise}")
    return results
