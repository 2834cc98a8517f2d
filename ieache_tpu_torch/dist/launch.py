"""Start ``world`` ranks as processes on one host.

The port's counterpart of the JAX package's virtual devices
(``--xla_force_host_platform_device_count``): each rank is a process,
started by ``spawn`` (never ``fork``: the caller may have threads, JAX's
among them), with one torch thread, joined to a process group on a free
TCP port of this host, NCCL on ``cuda`` (rank r on ``cuda:r``) and gloo
on ``cpu``.  There is no fallback: ranks asked for ``cuda`` on a host
with fewer cards raise.

    results = launch.run(fn, 4, arg, device="cpu")

calls ``fn(device, arg)`` on each rank, inside its process group, and
returns the ranks' results in rank order.  ``fn`` must be importable by
name (a module-level function), and its arguments and result
picklable.  A rank that raises, or a run past ``timeout``, raises
``RuntimeError`` here with the rank's traceback.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

#: seconds a rank waits on a collective, and the parent on all ranks
TIMEOUT = 600.0

#: seconds the parent waits, after a rank reports a failure, for the
#: other ranks to exit: a rank that died shows in its peers as a broken
#: connection, and the run names the death, not that symptom
DEATH_WAIT = 5.0


def free_port() -> int:
    """A TCP port of this host that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank: int, world: int, address: str, device="cuda",
         timeout: float = TIMEOUT) -> torch.device:
    """Join this process, as ``rank`` of ``world``, to the process group
    whose TCP store is at ``address`` (``host:port``); returns the rank's
    device: ``cuda:<local rank>`` (NCCL) or the CPU (gloo)."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{address}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return device


def _rank_main(rank, world, port, device, timeout, fn, args, results):
    torch.set_num_threads(1)
    try:
        dev = init(rank, world, f"127.0.0.1:{port}", device, timeout)
        try:
            results.put((rank, True, fn(dev, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the rank's boundary: reported
        results.put((rank, False, traceback.format_exc()))


def _dead(procs: list, reported, wait: float = 0.0) -> dict:
    """{rank: exit code} of the ranks not in ``reported`` that exited
    with a failure; where ``wait`` > 0, once every such rank has exited
    or ``wait`` seconds have passed."""
    deadline = time.monotonic() + wait
    while (time.monotonic() < deadline
           and any(p.exitcode is None for r, p in enumerate(procs)
                   if r not in reported)):
        time.sleep(0.05)
    return {r: p.exitcode for r, p in enumerate(procs)
            if r not in reported and p.exitcode not in (None, 0)}


def run(fn, world: int, *args, device="cuda", timeout: float = TIMEOUT) -> list:
    """``fn(device, *args)`` on each of ``world`` ranks; their results in
    rank order."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks on cuda need {world} CUDA "
                           f"devices; this host has "
                           f"{torch.cuda.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, device.type, timeout, fn, args,
                               results))
             for r in range(world)]
    for proc in procs:
        proc.start()
    got, failed = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world and not failed:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that died before it could report (killed, or
                # failed while its process started) fails the run now
                dead = _dead(procs, ())
                if dead:
                    failed.append(f"ranks exited without a result: {dead}")
                elif time.monotonic() > deadline:
                    failed.append(f"no result within {timeout} s from ranks "
                                  f"{sorted(set(range(world)) - set(got))}")
                continue
            if ok:
                got[rank] = value
            else:
                failed.append(f"rank {rank}:\n{value}")
                dead = _dead(procs, {*got, rank}, DEATH_WAIT)
                if dead:
                    failed.insert(0, f"ranks exited without a result: {dead}")
    finally:
        for proc in procs:
            proc.join(timeout=30 if not failed else 1)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if failed:
        raise RuntimeError("launch.run failed: " + "\n".join(failed))
    return [got[r] for r in range(world)]
