"""A launcher of `n` ranks on one host: the port's counterpart of the
virtual-device mesh that JAX's parallel tests and `dryrun_multichip` run
on. JAX runs every device of a mesh from one process; `torch.distributed`
needs one process per rank, so a sharded run on one host is `n` spawned
processes joined into one process group.

`launch(body, n_ranks, ...)` spawns the ranks, each of which joins the
group through a `file://` store in a fresh temporary directory (no fixed
TCP port: several launches may run on one host at once), calls
`body(rank, world, *args)` and hands its return value back. `body` must be
a function at the top level of an importable module (it is pickled by
name), and what it returns must pickle. A rank body never imports a test
module or jax: the bodies that the tests, `entry.dryrun_multichip` and
`chip_smoke.py` run live in `parallel/certify.py`.

Every wait is bounded. `init_process_group` and the group's collectives
get `timeout` seconds, and the parent kills every rank that has not
finished within `timeout` (plus the rank's start-up): a hang fails the
caller with `TimeoutError` and leaves no process behind.
"""

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable

# A spawned rank starts a fresh interpreter and imports torch and the
# package before it joins the group.
_START_UP_SECONDS = 60.0


def _rank_main(body, rank: int, world: int, backend: str, device: str, store: str, out: str, timeout: float,
               args: tuple, env: dict) -> None:
    os.environ.update(env)
    import torch
    import torch.distributed as dist

    if device == "cpu":
        # The ranks share the host's cores: one thread each.
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=store, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = ("ok", body(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        result = ("error", traceback.format_exc())
        Path(out).write_bytes(pickle.dumps(result))
        raise
    Path(out).write_bytes(pickle.dumps(result))


def launch(
    body: Callable[..., Any],
    n_ranks: int,
    *,
    backend: str = "gloo",
    device: str = "cpu",
    timeout: float = 120.0,
    args: tuple = (),
    env: dict | None = None,
) -> list:
    """Run `body(rank, n_ranks, *args)` on `n_ranks` spawned processes joined
    into one `backend` process group; return the ranks' results in rank
    order. `device` is `"cpu"` or `"cuda"` (rank r then uses card
    `r % device_count`); `env` is set in each rank's environment before it
    imports anything. Raises `RuntimeError` with the rank's traceback if a
    rank fails, `TimeoutError` if the ranks have not all finished within
    `timeout` seconds after start-up."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="genjax_launch_") as tmp:
        store = "file://" + str(Path(tmp) / "store")
        outs = [str(Path(tmp) / f"rank{r}.pkl") for r in range(n_ranks)]
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(body, r, n_ranks, backend, device, store, outs[r], timeout, args, dict(env or {})))
            for r in range(n_ranks)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout + _START_UP_SECONDS
        try:
            # A rank that fails leaves the others waiting in a collective:
            # stop them all as soon as one exits with an error.
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.02)
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            if late and not any(p.exitcode not in (None, 0) for p in procs):
                raise TimeoutError(f"launch: ranks {late} of {n_ranks} did not finish within {timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10.0)
        # A rank's own error first: the others may only have been stopped.
        results = [pickle.loads(Path(out).read_bytes()) if Path(out).exists() else None for out in outs]
        for r, res in enumerate(results):
            if res is not None and res[0] != "ok":
                raise RuntimeError(f"launch: rank {r} of {n_ranks} failed:\n{res[1]}")
        for r, (p, res) in enumerate(zip(procs, results)):
            if res is None:
                raise RuntimeError(f"launch: rank {r} of {n_ranks} exited with code {p.exitcode} and no result")
        return [value for _, value in results]


__all__ = ["launch"]
