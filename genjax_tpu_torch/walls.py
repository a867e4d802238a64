"""Host-clock walls of the particle path on one CUDA card, against another
checkout of the package, in one process.

    python3 -m genjax_tpu_torch.walls --against DIR [--rounds 200]

Loads `genjax_tpu_torch` twice into one process, from DIR (say the parent
commit, unpacked with `git archive`) and from this checkout, by swapping
the package's entries of `sys.modules` between the two. Then it times,
round after round, one SIR trial (beta-bernoulli, K=1,000,000:
importance, the LML, one draw), the `entry()` filter (K=4096, T=20) and
the filter at K=1,000,000, T=50, each once from either checkout, in the
order DIR, this in even rounds and this, DIR in odd ones; every run sits
between two device synchronisations. It prints, per configuration, the
median and quartiles of each side and in how many rounds this checkout
was slower, then one JSON line with every time.

Host times spread by up to 2x between processes on a shared host while
runs next to each other in one process see the same host, so only such
interleaved pairs resolve a host-side change of a few percent.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PACKAGE = "genjax_tpu_torch"
HERE = Path(__file__).resolve().parents[1]


def _loaded() -> list[str]:
    return [m for m in sys.modules if m == PACKAGE or m.startswith(PACKAGE + ".")]


def load(checkout: Path) -> dict:
    """The package's modules imported from `checkout`, taken out of
    `sys.modules` again."""
    for m in _loaded():
        del sys.modules[m]
    sys.path.insert(0, str(checkout))
    try:
        for m in ("", ".entry", ".models.beta_bernoulli", ".models.ssm", ".lang.interop"):
            __import__(PACKAGE + m)
    finally:
        sys.path.pop(0)
    mods = {m: sys.modules[m] for m in _loaded()}
    for m in mods:
        del sys.modules[m]
    return mods


def install(mods: dict) -> None:
    """Make `mods` the package that imports inside its functions see."""
    for m in _loaded():
        del sys.modules[m]
    sys.modules.update(mods)


def configurations(mods: dict) -> dict:
    """The timed calls, built from one checkout's modules."""
    install(mods)
    gx = mods[PACKAGE]
    beta_bernoulli = mods[PACKAGE + ".models.beta_bernoulli"].beta_bernoulli
    ssm = mods[PACKAGE + ".models.ssm"]
    rng = torch.Generator(device="cuda").manual_seed(0)
    alg = gx.ImportanceK(gx.Target(beta_bernoulli, (2.0, 2.0), gx.ChoiceMap.d({"v": True})), k_particles=1_000_000)

    def sir():
        col = alg.run_smc(rng)
        return col.get_log_marginal_likelihood_estimate(), col.sample_particle(rng)

    small, _ = mods[PACKAGE + ".entry"].entry("cuda")
    _, ys = ssm.simulate_ssm_data(torch.Generator().manual_seed(1), 50)
    ys = ys.to("cuda")
    return {
        "sir": sir,
        "filter_4096": lambda: small(rng),
        "filter_1m": lambda: ssm.run_bootstrap_filter(rng, ys, n_particles=1_000_000),
    }


def timed(mods: dict, fn) -> float:
    install(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def quartiles(xs: list[float]) -> tuple[float, float, float]:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return q1, q2, q3


def pairs(against: Path, rounds: int) -> dict:
    sides = {"against": load(against), "this": load(HERE)}
    fns = {side: configurations(mods) for side, mods in sides.items()}
    times = {name: {"against": [], "this": []} for name in fns["this"]}
    for _ in range(3):  # warm up: kernel builds, allocator, caches
        for side in sides:
            for name in times:
                timed(sides[side], fns[side][name])
    for r in range(rounds):
        order = ("against", "this") if r % 2 == 0 else ("this", "against")
        for name in times:
            for side in order:
                times[name][side].append(timed(sides[side], fns[side][name]))
    summary = {}
    for name, t in times.items():
        a, b = t["against"], t["this"]
        qa, qb = quartiles(a), quartiles(b)
        summary[name] = {
            "against_ms": qa, "this_ms": qb,
            "this_over_against": qb[1] / qa[1],
            "rounds_slower_here": sum(y > x for x, y in zip(a, b)), "rounds": rounds,
        }
        print(f"{name}: {against.name} {qa[1]:.3f} ms (quartiles {qa[0]:.3f}, {qa[2]:.3f}), this checkout "
              f"{qb[1]:.3f} ms (quartiles {qb[0]:.3f}, {qb[2]:.3f}); this / {against.name} = {qb[1] / qa[1]:.4f}; "
              f"slower here in {summary[name]['rounds_slower_here']} of {rounds} rounds")
    return {"summary": summary, "times": times}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("walls: no CUDA device (torch.cuda.is_available() is False)")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, required=True, help="another checkout of the repository")
    parser.add_argument("--rounds", type=int, default=200)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, **pairs(args.against.resolve(), args.rounds)}))


if __name__ == "__main__":
    main()
