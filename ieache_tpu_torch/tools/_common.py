"""What the port's tools and ``chip_smoke.py`` share: the card check,
the card's line and state, the parameter sets by name, an environment
override, the fields every tool's line carries, and the timers.

A timer needs a CUDA device; it never falls back to the CPU's clock.
"""

from __future__ import annotations

import contextlib
import os
import subprocess

import torch

from ieache_tpu_torch import params as P
from ieache_tpu_torch.ops.blind_rotate import step_mode
from ieache_tpu_torch.utils.trace import sync  # noqa: F401  (the tools' fence)

#: the full-size parameter sets the tools take by name (``*_PARAMS``)
PARAMS = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
          "ieache_110_tfhe_compat": P.IEACHE_110_TFHE_COMPAT}


def require_cuda(what: str) -> torch.device:
    """The current CUDA device, or exit: ``what`` measures the card and
    does not fall back to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: no CUDA device; this run needs one and "
                         f"does not fall back to the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def line_fields(device) -> dict:
    """The fields a tool's JSON line adds to the JAX tool's: the backend,
    the step mode of the blind rotation, the platform, the device's name
    and the card's name and power limit (None on the CPU)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    return {"backend": "torch", "step_mode": step_mode(),
            "platform": "gpu" if on_card else "cpu",
            "device": torch.cuda.get_device_name(device) if on_card
            else "cpu",
            "card": card_line() if on_card else None}


def _nvidia_smi(fields: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return _nvidia_smi("name,power.limit")


def card_state() -> str:
    """The card's SM clock, its maximum, power draw and temperature
    now: a card that runs below its maximum clock explains times that
    differ between two runs."""
    return _nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")


@contextlib.contextmanager
def environ(name: str, value: str | None):
    """Run the block with the environment variable ``name`` set to
    ``value`` (unset for None), restored afterwards."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def events_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up,
    between two CUDA events (host cost per call included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 1) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed ``replays`` times between two CUDA events, so the host's
    per-call cost (the Python wrapper, the launch) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


#: the bytes a cold timing cycles through: four times the H100's 50 MB L2
COLD_BYTES = 4 * 50 * 10**6


def cold_copies(nbytes: int, cycle: int = COLD_BYTES) -> int:
    """How many copies of a call's ``nbytes`` of input a cold timing
    needs so that one cycle through them reads ``cycle`` bytes."""
    return max(2, -(-cycle // nbytes))


def graph_ms_cold(calls, reps: int) -> float:
    """Device ms per call with the L2 cold: ``reps`` calls captured in
    one CUDA graph that cycles through ``calls`` (each on its own copy
    of the inputs, :func:`cold_copies` of them) and keeps every output,
    so that no call finds its inputs, or the memory it writes, in the
    L2 from an earlier call; replayed once between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [calls[i % len(calls)]() for i in range(reps)]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del outs
    return start.elapsed_time(end) / reps
