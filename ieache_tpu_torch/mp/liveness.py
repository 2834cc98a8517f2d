"""Host liveness checks — the reference's ping-based admission.

The port's own copy of :mod:`ieache_tpu.mp.liveness`, pinned to it by
``tests/test_torch_mp.py``.

The reference gates work on host liveness in two places: Keygen
ping-discovers live clients before serving keys
(``/root/reference/Keygen/dragonfly_private_keygen.py:685-689``) and
the Output CLI validates every operand host with an IPv4 format check
plus a ping (``/root/reference/Output/output_dynamic.py:1096-1113``).

ICMP ping requires privileges and doesn't prove the *service* is up,
so the probe order here is: TCP connect to the expected service port
(the definitive signal — the peer's listener answers), falling back to
``ping -c 1`` when no port is known.
"""

from __future__ import annotations

import socket
import subprocess


def probe_tcp(host: str, port: int, timeout: float = 1.0) -> bool:
    """True if a TCP listener answers at host:port."""
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


def ping(host: str, timeout_s: int = 1) -> bool:
    """``ping -c 1`` (the reference's ``ping -c 2`` check,
    `output_dynamic.py:1098-1110`); False if ping is unavailable."""
    try:
        r = subprocess.run(
            ["ping", "-c", "1", "-W", str(timeout_s), host],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            timeout=timeout_s + 2,
        )
        return r.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def host_alive(host: str, port: int | None = None,
               timeout: float = 1.0) -> bool:
    """Service-level liveness: TCP probe when a port is known (with a
    ping fallback), plain ping otherwise."""
    if port is not None:
        return probe_tcp(host, port, timeout) or ping(host)
    return ping(host)
