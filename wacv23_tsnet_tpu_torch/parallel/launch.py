"""Start the ranks of a `torch.distributed` program on one host.

`init_distributed` joins the calling process to a process group: NCCL
for a CUDA device, gloo for the CPU, unless the caller names the backend
(two ranks on one GPU run gloo on CUDA tensors: NCCL refuses two ranks on
one device). The rendezvous is the caller's `init_method`: a
`file://` path shared by the ranks (a `FileStore`, no port to pick) or
`tcp://localhost:<port>`.

`spawn_ranks` runs `fn(rank, world_size, *args)` in `world_size` fresh
`spawn` processes and returns their results in rank order, tensors in
them as numpy arrays. A rank that
raises, dies or outlives `timeout` fails the call, and every rank still
running is killed, so a hung collective fails its caller instead of
holding it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device


# how long a collective may wait for its peers
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(rank: int, world_size: int, init_method: str,
                     device="cuda", backend=None) -> str:
    """Join the default process group; returns the backend. `device` is
    where the caller's tensors live (the GPU unless it asks for the
    CPU)."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=COLLECTIVE_TIMEOUT)
    return backend


def _host(value):
    """value with every tensor in its dicts, lists and tuples as a numpy
    array: torch would send a CPU tensor through the queue as shared
    memory of a process that is about to exit."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host(v) for v in value)
    return value


def _rank_main(fn, rank: int, world_size: int, args: tuple, results) -> None:
    try:
        value = _host(fn(rank, world_size, *args))
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args: tuple = (),
                timeout: float = 300.0) -> list:
    """[fn(r, world_size, *args) for each rank r], each in its own
    spawned process; `fn` must be importable by name and its results
    picklable."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world_size, tuple(args), results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(got))
                raise TimeoutError(f"ranks {missing} did not finish within "
                                   f"{timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a rank's result may still be in flight: one last look
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        code = procs[dead[0]].exitcode
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code {code} and "
                            "no result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        # every rank has reported when all went well: give them time to
        # exit; else kill at once what still runs (a rank may hang in a
        # collective whose peer failed)
        grace = 30.0 if len(got) == world_size else 0.0
        for p in procs:
            p.join(timeout=grace)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(world_size)]
