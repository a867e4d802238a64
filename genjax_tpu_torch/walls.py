"""Host-clock walls of the particle path on one CUDA card, against another
checkout of the package, in one process.

    python3 -m genjax_tpu_torch.walls --against DIR [--rounds 200] [--edits]

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

With `--edits` it times static edits instead: 10 steps of P2's block-move
MH over the two-component mixture (`mix`, C=8192) and 10 Gibbs sweeps of
eight schools (non-centered, over mu, log_tau and z, C=8192), each from
the same start state every time, on three sides in rotating order: DIR,
this checkout (its edit plan), and this checkout with every edit under its
fallback plan (`lang/static.py::_FALLBACK_PLAN`, dense: every site
recomputed under unknown argdiffs). After the rounds, each side's own
`profiling.trace` counts its launch calls per step.

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
        for m in ("", ".entry", ".models.beta_bernoulli", ".models.ssm", ".lang.interop",
                  ".models.hierarchical", ".lang.static", ".profiling"):
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


def edit_configurations(mods: dict) -> dict:
    """The timed static edits, built from one checkout's modules."""
    install(mods)
    gx = mods[PACKAGE]
    h = mods[PACKAGE + ".models.hierarchical"]
    rng = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.tensor((0.3, -0.2), device="cuda")

    @gx.gen
    def narrow():
        return gx.normal(0.0, 1.0) @ "v"

    @gx.gen
    def wide():
        return gx.normal(5.0, 2.0) @ "v"

    @gx.gen
    def mixture():
        v = gx.mix(narrow, wide)(logits, (), ()) @ "m"
        return gx.normal(v, 0.5) @ "y"

    at = gx.Selection.at
    chains, _ = mixture.importance(rng, gx.ChoiceMap.kw(y=2.5), (), n=8192)
    block = gx.Regenerate(at["m", "mixture_component"] | at["m", "component_sample", ...])
    sigma, y = h.EIGHT_SCHOOLS_SIGMA.to("cuda"), h.EIGHT_SCHOOLS_Y.to("cuda")
    schools, _ = h.eight_schools.importance(rng, gx.ChoiceMap.kw(ys=y), (sigma,), n=8192)
    sels = [at[a] for a in ("mu", "log_tau", "z")]
    return {
        "p2_block_mh_10_steps": lambda: gx.run_chains(rng, chains, block, 10),
        "schools_gibbs_10_sweeps": lambda: gx.gibbs_chain(rng, schools, sels, 10),
    }


def under_fallback_plan(mods: dict, fn):
    """`fn` with every static edit of `mods`' package under its fallback
    plan."""
    static = mods[PACKAGE + ".lang.static"]

    def run():
        real = static._static_edit_plan
        static._static_edit_plan = lambda *a, **k: static._FALLBACK_PLAN
        try:
            return fn()
        finally:
            static._static_edit_plan = real

    return run


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


def pairs(against: Path, rounds: int, edits: bool = False) -> dict:
    loaded = {"against": load(against), "this": load(HERE)}
    build = edit_configurations if edits else configurations
    fns = {side: build(mods) for side, mods in loaded.items()}
    sides = {side: (loaded[side], fns[side]) for side in loaded}
    if edits:
        sides["this_fallback"] = (loaded["this"], {n: under_fallback_plan(loaded["this"], f) for n, f in fns["this"].items()})
    names = list(sides)
    times = {name: {side: [] for side in sides} for name in fns["this"]}
    for _ in range(3):  # warm up: kernel builds, allocator, caches
        for mods, side_fns in sides.values():
            for name in times:
                timed(mods, side_fns[name])
    for r in range(rounds):
        order = names[r % len(names):] + names[: r % len(names)] if edits else (
            names if r % 2 == 0 else names[::-1])
        for name in times:
            for side in order:
                mods, side_fns = sides[side]
                times[name][side].append(timed(mods, side_fns[name]))
    launches = {}
    if edits:  # each side's own profiler, 10 steps or sweeps per call
        for name in times:
            launches[name] = {}
            for side, (mods, side_fns) in sides.items():
                install(mods)
                prof = mods[PACKAGE + ".profiling"].trace(side_fns[name], 10)
                launches[name][side] = prof["launch_calls_per_step"]
    summary = {}
    for name, t in times.items():
        a = t["against"]
        qa = quartiles(a)
        summary[name] = {"against_ms": qa, "rounds": rounds}
        line = [f"{name}: {against.name} {qa[1]:.3f} ms (quartiles {qa[0]:.3f}, {qa[2]:.3f})"]
        for side in names[1:]:
            b = t[side]
            qb = quartiles(b)
            summary[name].update({
                f"{side}_ms": qb, f"{side}_over_against": qb[1] / qa[1],
                f"rounds_slower_{side}": sum(y > x for x, y in zip(a, b)),
            })
            line.append(f"{side} {qb[1]:.3f} ms (quartiles {qb[0]:.3f}, {qb[2]:.3f}); {side} / {against.name} = "
                        f"{qb[1] / qa[1]:.4f}, slower in {summary[name][f'rounds_slower_{side}']} of {rounds} rounds")
        if launches:
            summary[name]["launch_calls_per_step"] = launches[name]
            line.append("launch calls per step " + ", ".join(f"{k} {v:.1f}" for k, v in launches[name].items()))
        print("; ".join(line))
    return {"summary": summary, "times": times}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("walls: no CUDA device (torch.cuda.is_available() is False)")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, required=True, help="another checkout of the repository")
    parser.add_argument("--rounds", type=int, default=200)
    parser.add_argument("--edits", action="store_true", help="time static edits (P2, eight-schools Gibbs)")
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, **pairs(args.against.resolve(), args.rounds, args.edits)}))


if __name__ == "__main__":
    main()
