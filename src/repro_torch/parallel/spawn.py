"""Start the ranks of a sharded run: one process each, a gloo process
group over localhost.

``spawn(fn, world, args)`` starts ``world`` processes (the spawn start
method: each imports the port afresh), initializes the default process
group in each (``tcp://localhost:<a free port>``, the world size, the
rank) and calls ``fn(rank, world, device, *args)``; it returns the
ranks' results in rank order and raises with a rank's traceback if any
rank failed.  The ranks run on the card unless ``device`` is "cpu":
"cuda", the default, runs rank r on ``cuda:(r % cards)``, so
ranks share a card when there are fewer cards than ranks; gloo carries
the collectives there too (NCCL refuses two ranks on one device).  The
CUDA kernels are built here, in the parent, before any rank starts, so
that the ranks load them instead of racing one another's builds.
Each rank runs torch on ``threads`` intra-op threads.
"""
from __future__ import annotations

import datetime
import queue as queue_mod
import socket
import traceback
from typing import Any, Callable, List

import torch

from repro_torch import telemetry as T


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(rank: int, device: str) -> torch.device:
    """The device of rank ``rank``: the CPU, or card ``rank % cards``."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the ranks run on cuda by default and no CUDA "
                           "device is available; pass device='cpu'")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _entry(rank, world, port, device, threads, timeout, fn, args, queue):
    import torch.distributed as dist
    try:
        torch.set_num_threads(threads)
        if device != "cpu":
            torch.cuda.set_device(rank_device(rank, device))
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            queue.put((rank, True, fn(rank, world, device, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args=(), *, device: str = "cuda",
          threads: int = 1, timeout: float = 900.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks; their
    results in rank order.  ``fn`` must be importable (a module-level
    function)."""
    import torch.multiprocessing as mp
    if world < 2:
        raise ValueError(f"a sharded run needs at least 2 ranks, got "
                         f"{world}")
    if device != "cpu":
        rank_device(0, device)                  # raises without a card
        from repro_torch.kernels import _build
        _build.build_all()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(
        r, world, port, device, threads, timeout, fn, args, queue))
        for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = T.walltime() + timeout
    try:
        while len(results) < world and not errors:
            try:
                rank, ok, out = queue.get(timeout=1.0)
            except queue_mod.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)}
                if dead:
                    errors.append(f"ranks exited with codes {dead}")
                elif T.walltime() > deadline:
                    errors.append(f"no result after {timeout} s")
                continue
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("a rank failed\n" + "\n".join(errors))
    return [results[r] for r in range(world)]
