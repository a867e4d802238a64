"""PyTorch's gamma and binomial samplers beside the closed forms that the
JAX library uses as TPU speed paths (`genjax_tpu/distributions/library.py`:
`_fast_gamma_unit`, Gamma(n + 1/2) as -log of n uniforms' product plus
Z^2 / 2; the small-count binomial as a sum of n Bernoulli draws), on one
CUDA card at a million draws.

Each pair is timed in turns with `profiling.device_and_host` (device time
per call of calls queued behind a sleep kernel), and each closed form's
mean is held within 5 SE of the exact one; each is called twice before
it is timed (the first launch of a kernel loads its module). The port
takes a closed form only where it is faster than the builtin.

Run from the repository root, with one CUDA card visible:

    python3 -m genjax_tpu_torch.sampler_probe

The last line of standard output is one JSON object with every number.
"""

import json
import math
import subprocess

import torch

N = 1_000_000
CALLS = 20
SHAPES = tuple(0.5 * k for k in range(1, 18))  # 0.5, 1.0, ..., 8.5
COUNTS = tuple(range(1, 17))
P = 0.3


def gamma_closed_form(rng: torch.Generator, shape: float, n: int) -> torch.Tensor:
    """Gamma(shape, 1) for a half-integer shape: the sum of k Exp(1) draws
    (-log of uniforms) plus Z^2 / 2 for the half."""
    k, half = divmod(int(round(2 * shape)), 2)
    out = torch.zeros(n, device=rng.device)
    if k:
        u = torch.rand((n, k), generator=rng, device=rng.device).clamp_(min=torch.finfo(torch.float32).tiny)
        out = -torch.log(u).sum(-1)
    if half:
        z = torch.randn(n, generator=rng, device=rng.device)
        out = out + 0.5 * z * z
    return out


def binomial_closed_form(rng: torch.Generator, count: int, p: float, n: int) -> torch.Tensor:
    """Binomial(count, p) as the number of `count` uniforms below p."""
    return (torch.rand((n, count), generator=rng, device=rng.device) < p).sum(-1, dtype=torch.float32)


def main() -> None:
    from genjax_tpu_torch.profiling import device_and_host

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(0)
    rows = {"gamma": {}, "binomial": {}}
    for a in SHAPES:
        c = torch.full((N,), a, device=dev)
        pair = {"builtin": lambda x: torch._standard_gamma(x, generator=rng),
                "closed": lambda x: gamma_closed_form(rng, a, N)}
        times = {k: [] for k in pair}
        for fn in pair.values():
            device_and_host(fn, c, 2)  # warm up: the first launch of a kernel loads its module
        for label in [*pair, *reversed(pair)]:
            times[label].append(device_and_host(pair[label], c, CALLS)[0])
        draws = gamma_closed_form(rng, a, N).double()
        se = math.sqrt(a / N)
        assert abs(float(draws.mean()) - a) < 5 * se, (a, float(draws.mean()))
        rows["gamma"][a] = {k: sum(v) / len(v) for k, v in times.items()}
        print(f"[{card}] gamma shape {a}: torch._standard_gamma {rows['gamma'][a]['builtin']:.4f} ms, closed form "
              f"{rows['gamma'][a]['closed']:.4f} ms per {N} draws")
    for count in COUNTS:
        cnt, prob = torch.full((N,), float(count), device=dev), torch.full((N,), P, device=dev)
        pair = {"builtin": lambda x: torch.binomial(x, prob, generator=rng),
                "closed": lambda x: binomial_closed_form(rng, count, P, N)}
        times = {k: [] for k in pair}
        for fn in pair.values():
            device_and_host(fn, cnt, 2)
        for label in [*pair, *reversed(pair)]:
            times[label].append(device_and_host(pair[label], cnt, CALLS)[0])
        draws = binomial_closed_form(rng, count, P, N).double()
        se = math.sqrt(count * P * (1 - P) / N)
        assert abs(float(draws.mean()) - count * P) < 5 * se, (count, float(draws.mean()))
        rows["binomial"][count] = {k: sum(v) / len(v) for k, v in times.items()}
        print(f"[{card}] binomial count {count}: torch.binomial {rows['binomial'][count]['builtin']:.4f} ms, closed "
              f"form {rows['binomial'][count]['closed']:.4f} ms per {N} draws")
    print(json.dumps({"card": card, "n": N, **rows}))


if __name__ == "__main__":
    main()
