"""Variants of kernel K1 timed beside it on one CUDA card, and the host
side of one K1 call taken apart.

The variants are in `csrc/k1_probe.cu`, whose header says what each one
changes; the package never launches them. At each size of `SIZES`, every
variant is first held against `ops.logsumexp_plain` (1e-5 * max(1, |ref|)),
then K1 and the variants are timed in turns, forwards and then backwards,
with `profiling.device_and_host` (device time per call of calls queued
behind a sleep kernel). Both entry points of K1 are also timed by the
profiler's CUPTI kernel intervals, which leave out the gaps between
launches. Then the host side of `ops.fused_logsumexp` is timed piece by
piece, each piece over `HOST_CALLS` calls on the host clock.

Run from the repository root, with one CUDA card visible:

    python3 -m genjax_tpu_torch.k1_probe

The last line of standard output is one JSON object with every number.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import time

import torch

SIZES = (4_096, 1_000_000, 16_777_216)
CALLS = 50
HOST_CALLS = 150  # few enough that no piece fills the device's launch queue
# Variant -> (its code in k1_probe_f32, float32 values a block reads per
# grid step, resident blocks per SM): the grid is K1's launch_geometry
# with those two numbers in place of 4096 and 4.
VARIANTS = {
    "prefetch": (0, 4096, 4),
    "bulk": (1, 2048, 4),
    "even": (2, 4096, 4),
    "vec8": (3, 8192, 4),
    "6/SM": (4, 4096, 6),
    "8/SM": (5, 4096, 8),
    "empty": (6, 4096, 4),
    "1-pass": (7, 4096, 4),
    "acq_rel": (8, 4096, 4),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM at 700 W


def _library() -> ctypes.CDLL:
    from genjax_tpu_torch.ops import _build

    # The probe includes logsumexp.cu, which the name of its build does
    # not hash, so it is built afresh on every run.
    _build.library_path("k1_probe").unlink(missing_ok=True)
    lib = _build.load_library("k1_probe")
    args = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.k1_probe_f32.argtypes = [ctypes.c_int, *args[:6], ctypes.c_void_p]
    lib.k1_probe_noop.argtypes = args
    lib.k1_probe_f32.restype = lib.k1_probe_noop.restype = ctypes.c_int
    return lib


def _variant(lib: ctypes.CDLL, name: str, workspace: torch.Tensor, sm_count: int):
    """A function x -> logsumexp(x) that launches variant `name` of K1 on
    the current stream, with a workspace of its own (one stream only)."""
    code, block_step, per_sm = VARIANTS[name]
    partials, counter = workspace.data_ptr(), workspace.data_ptr() + 16 * (workspace.numel() // 4 - 1)

    def run(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((), dtype=torch.float32, device=x.device)
        blocks = max(1, min(-(-x.numel() // block_step), per_sm * sm_count))
        err = lib.k1_probe_f32(code, x.data_ptr(), x.numel(), partials, counter, out.data_ptr(), blocks,
                               torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"k1_probe variant {name}: CUDA error {err}")
        return out

    return run


def _kernel_us(fn, x: torch.Tensor, calls: int = CALLS) -> float:
    """Mean CUPTI duration, in us, of the K1 kernels that `calls` calls of
    `fn(x)` launch (the kernel alone, without the gaps between launches)."""
    cuda = torch.autograd.DeviceType.CUDA
    fn(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(x)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == cuda and "genjax_lse" in e.name]
    # The trace may miss a kernel at its edges; it must hold most of them.
    if not calls // 2 <= len(spans) <= calls:
        raise RuntimeError(f"k1_probe: {len(spans)} K1 kernels in the trace of {calls} calls")
    return statistics.fmean(spans)


def _host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of `fn()`, with a sleep kernel holding
    the device so that launches never wait for it."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 100 ms at 1.98 GHz
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe: no CUDA device (torch.cuda.is_available() is False)")
    from genjax_tpu_torch import ops
    from genjax_tpu_torch.profiling import device_and_host

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    lib = _library()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = torch.Generator(device=dev).manual_seed(0)
    results = {"card": card, "device_ms": {}, "host_us": {}}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    # Room for 8 partials per SM, then the counter, zeroed once.
    workspace = torch.zeros(4 * (8 * sm_count + 1), dtype=torch.float32, device=dev)

    for n in SIZES:
        x = 3.0 * torch.randn(n + 1, generator=rng, device=dev)
        fns = {"K1": ops.fused_logsumexp, "torch.logsumexp": lambda v: torch.logsumexp(v, 0)}
        fns.update({name: _variant(lib, name, workspace, sm_count) for name in VARIANTS})
        for name, fn in fns.items():
            if name == "empty":
                continue
            for v in (x[:n], x[1:]):  # aligned, unaligned
                got, ref = float(fn(v)), float(ops.logsumexp_plain(v))
                if abs(got - ref) > 1e-5 * max(1.0, abs(ref)):
                    raise RuntimeError(f"k1_probe: {name} at N={n}: {got} vs plain {ref}")
        v = x[:n]
        times = {name: [] for name in fns}
        for fn in fns.values():
            device_and_host(fn, v, 5)  # warm up
        for name in [*fns, *reversed(fns)]:
            times[name].append(device_and_host(fns[name], v, CALLS // 2)[0])
        ms = {name: statistics.fmean(t) for name, t in times.items()}
        results["device_ms"][n] = ms
        bound_ms = 1e3 * 4 * (n + 1) / HBM_BYTES_PER_S
        print(f"[{card}] N={n}: device ms per call ({CALLS} calls behind a sleep kernel), bound {bound_ms:.5f} ms: "
              + "; ".join(f"{name} {t:.4f} ({100 * bound_ms / t:.1f}% of bound)" for name, t in ms.items()))

    results["kernel_us"] = {}
    for n in (4_096, 10_000, 1_000_000, 16_777_216):
        x = 3.0 * torch.randn(n, generator=rng, device=dev)
        results["kernel_us"][n] = {name: _kernel_us(fn, x) for name, fn in
                                   (("logsumexp", ops.fused_logsumexp), ("logsumexp_ess", ops.fused_logsumexp_ess))}
    print(f"[{card}] K1 kernel time alone (CUPTI intervals, mean of {CALLS}), us, logsumexp / logsumexp_ess: "
          + "; ".join(f"N={n} {t['logsumexp']:.2f} / {t['logsumexp_ess']:.2f}" for n, t in results["kernel_us"].items()))

    x = torch.randn(1_000_000, device=dev)
    out = torch.empty((), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    k1 = sys.modules["genjax_tpu_torch.ops.logsumexp"]
    _, partials, counter, sm_count = k1._workspace(dev, stream)
    args = (x.data_ptr(), x.numel(), partials, counter, out.data_ptr(), 245, 0, stream)
    pair = torch.empty(2, device=dev)
    pieces = {
        "torch.empty((), device=cuda)": lambda: torch.empty((), dtype=torch.float32, device=dev),
        "torch.empty(2, device=cuda)": lambda: torch.empty(2, dtype=torch.float32, device=dev),
        "pair.unbind()": pair.unbind,
        "(pair[0], pair[1])": lambda: (pair[0], pair[1]),
        "(pair.select(0, 0), pair.select(0, 1))": lambda: (pair.select(0, 0), pair.select(0, 1)),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)": lambda: torch._C._cuda_getCurrentRawStream(0),
        "workspace lookup and launch_geometry": lambda: (k1._workspace(dev, stream), k1.launch_geometry(x.numel(), sm_count)),
        "checks and dtype (_checked)": lambda: k1._checked(x),
        "ctypes call of a C no-op, 8 arguments": lambda: lib.k1_probe_noop(*args),
        "ctypes call launching an empty kernel": lambda: lib.k1_probe_f32(6, *args[:6], stream),
        "ctypes call launching K1": lambda: k1._kernel()(*args),
        "fused_logsumexp(x), whole": lambda: ops.fused_logsumexp(x),
        "fused_logsumexp_ess(x), whole": lambda: ops.fused_logsumexp_ess(x),
    }
    for name, fn in pieces.items():
        fn()
        results["host_us"][name] = _host_us(fn)
    print(f"[{card}] host us per call at N=1M ({HOST_CALLS} calls each, host clock): "
          + "; ".join(f"{name} {us:.2f}" for name, us in results["host_us"].items()))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
