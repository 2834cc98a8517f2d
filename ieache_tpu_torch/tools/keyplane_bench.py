"""Key-plane benchmark against the reference's Fig. 9/Fig. 10 numbers.

Counterpart of ``tools/keyplane_bench.py``.  The reference paper
(`AC058.pdf` p.4, BASELINE.md) measures the Dragonfly key-exchange
plane: 93.7 s before its optimisation, 71.7 s after, and 62.3/66.3/71.7
s for 1/2/3 clients.  This tool times the port's key plane end to end
at real λ=110 key sizes (the IEK1 secret blob is about 33 MB): per
peer, one SAE handshake, the AES-256-CBC wrap, the chunked DataKey BER
fan-out, the unwrap and the digest check, for 1/2/3 clients, in the
reference's admission order (Output first, the clients, then the
Cloud's bk+ks blob, which the Cloud unpacks onto its device).  It also
times the Output->Cloud job handshake and a whole tiny expression flow
(``mp/sim.py``, the Fig. 7 companion phase).

The clients are host work (``ClientNode(..., device="cpu")``); the
Cloud unpacks its key onto ``--device`` (``cuda``, the default: a run
without a card exits; no fallback).  With ``KB_PROC_CLIENTS=1`` (the
default) each client is a process of its own, started by ``spawn``
(never ``fork``: this process may have CUDA up); the seconds they take
to start (``client_start_s``) are left out of ``total_s``.  Run from the
root of a checkout:

    python -m ieache_tpu_torch.tools.keyplane_bench [--device cuda]

Env: KB_PARAMS (ieache_110_l2, the default; ieache_110; test_tiny),
KB_CLIENTS ("1,2,3"), KB_ITERS (3 per client count, the best kept),
KB_PROC_CLIENTS (1; 0 for threads in this process), KB_SUBPROC=1 adds
the deploy path's total as OS processes (``python -m
ieache_tpu_torch.cli.main serve``, test_tiny material).  Keysets come
from ``.keycache/`` (written there where absent).  One JSON line, the
JAX tool's keys plus ``tools/_common.line_fields``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import torch

from ieache_tpu_torch import params as P
from ieache_tpu_torch.codec import files
from ieache_tpu_torch.mp import sim
from ieache_tpu_torch.mp.config import localhost_config
from ieache_tpu_torch.mp.nodes import (
    ClientNode,
    CloudNode,
    KeygenNode,
    OutputNode,
)
from ieache_tpu_torch.tools._common import line_fields

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REF = {
    "pre_opt_s": 93.7,
    "opt_s": 71.7,
    "per_clients_s": {1: 62.3, 2: 66.3, 3: 71.7},
    "source": "AC058.pdf p.4 Fig.9/Fig.10 (BASELINE.md)",
}

#: KB_PARAMS names
PARAMS = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
          "test_tiny": P.TEST_TINY}


def _client_child(i, cfg, kaddr, barrier, results):
    """One client as its own process: ready, then the timed exchange."""
    torch.set_num_threads(1)
    c = ClientNode(i + 1, cfg=cfg, device="cpu")
    barrier.wait()
    t0 = time.time()
    c.receive_keys(kaddr)
    results.put((i, time.time() - t0))


def _clients_in_processes(nc, cfg, kaddr, phases):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    barrier = ctx.Barrier(nc + 1)
    procs = [ctx.Process(target=_client_child,
                         args=(i, cfg, kaddr, barrier, results))
             for i in range(nc)]
    t0 = time.time()
    for pr in procs:
        pr.start()
    try:
        barrier.wait(timeout=300)     # every child started: clock on
        phases["client_start_s"] = time.time() - t0
        t0 = time.time()
        got = [results.get(timeout=300) for _ in procs]
        phases["clients_concurrent_wall_s"] = time.time() - t0
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.kill()
    return [t for _, t in sorted(got)]


def _clients_in_threads(nc, cfg, kaddr, phases):
    per_client = [None] * nc
    clients = [ClientNode(i + 1, cfg=cfg, device="cpu") for i in range(nc)]

    def one(i):
        t0 = time.time()
        clients[i].receive_keys(kaddr)
        per_client[i] = time.time() - t0

    t0 = time.time()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(nc)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    phases["clients_concurrent_wall_s"] = time.time() - t0
    for c in clients:
        c.stop()
    return per_client


def one_run(p, pair, nc: int, device, proc_clients: bool = True) -> dict:
    """One key plane with ``nc`` clients: the phases' seconds."""
    cfg = localhost_config()
    phases = {}
    t_total0 = time.time()
    t0 = time.time()
    keygen_node = KeygenNode(p, pair=pair, cfg=cfg)
    phases["keygen_node_blobs_s"] = time.time() - t0
    kaddr = keygen_node.start(cfg.keygen.host, cfg.keygen.key_port)
    output = OutputNode(cfg=cfg)
    oaddr = output.start_indicator_server(cfg.output.host,
                                          cfg.output.key_port)
    cloud = None
    try:
        t0 = time.time()
        output.receive_keys(kaddr)       # SAE + AES unwrap + md5 check
        phases["output_exchange_s"] = time.time() - t0

        clients = _clients_in_processes if proc_clients \
            else _clients_in_threads
        phases["client_exchange_s"] = clients(nc, cfg, kaddr, phases)

        cloud = CloudNode(cfg=cfg, device=device)
        t0 = time.time()
        cloud.receive_keys(kaddr)        # bk+ks blob, unpacked on device
        if cloud.device.type == "cuda":
            torch.cuda.synchronize(cloud.device)
        phases["cloud_exchange_s"] = time.time() - t0

        keygen_node.notify_finished(oaddr)
        output.wait_finished()
        # spawned clients start in seconds (a fork took none): left out
        phases["total_s"] = (time.time() - t_total0
                             - phases.get("client_start_s", 0.0))
    finally:
        if cloud is not None:
            cloud.stop()
        keygen_node.stop()
        output.stop()
    return phases


def _rounded(v):
    if isinstance(v, float):
        return round(v, 4)
    if isinstance(v, list):
        return [round(x, 4) for x in v]
    return v


def run(p, counts, iters: int, device, proc_clients: bool = True,
        subproc: bool = False, keycache: str | None = None) -> dict:
    """The benchmark's record, the Cloud on ``device``."""
    device = torch.device(device)
    t0 = time.time()
    pair = files.cached_gate_keypair(
        keycache or os.path.join(REPO, ".keycache"), p)
    t_material = time.time() - t0

    node = KeygenNode(p, pair=pair)
    sizes = {"secret_blob_mb": round(len(node._secret_blob) / 1e6, 2),
             "cloud_blob_mb": round(len(node._cloud_blob) / 1e6, 2)}

    per_counts = {}
    for nc in counts:
        runs = [one_run(p, pair, nc, device, proc_clients)
                for _ in range(iters)]
        best = min(runs, key=lambda r: r["total_s"])
        ref = REF["per_clients_s"].get(nc)
        best["speedup_vs_fig10"] = (round(ref / best["total_s"], 1)
                                    if ref else None)
        per_counts[nc] = best
        print(f"# {nc} client(s): {best['total_s']:.3f}s (ref {ref}s)",
              file=sys.stderr, flush=True)

    # the Output->Cloud job handshake and a whole flow (tiny parameters:
    # this phase measures the protocol, not TFHE compute)
    t0 = time.time()
    r = sim.run_full_flow("AB+", {"A": [21], "B": [9]}, 8, P.TEST_TINY,
                          device=device)
    t_flow = time.time() - t0
    if r.values != [30]:
        raise AssertionError(f"the tiny flow decrypted {r.values}")

    result = {
        "probe": "keyplane_fig9_fig10",
        "params": p.name,
        **sizes,
        "material_once_s": round(t_material, 3),
        "per_clients": {str(k): {kk: _rounded(vv) for kk, vv in v.items()}
                        for k, v in per_counts.items()},
        "job_flow_tiny_total_s": round(t_flow, 3),
        "reference": REF,
        "mode": ("keygen threads + one OS process per client over loopback"
                 if proc_clients
                 else "in-process (threads over loopback sockets)"),
        "host_cores": os.cpu_count(),
        **line_fields(device),
    }
    if subproc:
        result["subproc_total_s"] = subproc_total(device)
    return result


def subproc_total(device) -> float | None:
    """Key plane + tiny expression as OS processes (the deploy path,
    tiny material): seconds, or None where the answer was wrong."""
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    socks, ports = [], []
    for _ in range(5):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    pk, pc1, pc2, pcl, po = ports
    kaddr = f"127.0.0.1:{pk}"

    def spawn(args, cwd):
        return subprocess.Popen(
            [sys.executable, "-m", "ieache_tpu_torch.cli.main", "serve"]
            + args, cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    with tempfile.TemporaryDirectory() as td:
        t0 = time.time()
        procs = [spawn(["--role", "keygen", "--params", "test_tiny",
                        "--bind", "127.0.0.1", "--port", str(pk),
                        "--expect-peers", "4",
                        "--output-addr", f"127.0.0.1:{po}",
                        "--clients", "127.0.0.1,127.0.0.1",
                        "--discover-port", str(pk), "--device", "cpu"], td)]
        for idx, port, val in [(1, pc1, 30), (2, pc2, 12)]:
            procs.append(spawn(
                ["--role", "client", "--index", str(idx),
                 "--keygen-addr", kaddr, "--bind", "127.0.0.1",
                 "--port", str(port), "--value", str(val), "--width", "8",
                 "--device", "cpu"], td))
        procs.append(spawn(
            ["--role", "cloud", "--keygen-addr", kaddr,
             "--bind", "127.0.0.1", "--port", str(pcl),
             "--device", str(device)], td))
        out = OutputNode()
        try:
            out.start_indicator_server("127.0.0.1", po)
            out.receive_keys(("127.0.0.1", pk))
            out.wait_finished(timeout=120)
            got = out.submit_job(
                ("127.0.0.1", pcl), "AB+",
                {"A": ("127.0.0.1", pc1), "B": ("127.0.0.1", pc2)},
                timeout=120)
            return round(time.time() - t0, 3) if got == [42] else None
        finally:
            out.stop()
            for pr in procs:
                pr.terminate()
            for pr in procs:
                try:
                    pr.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pr.kill()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the Cloud unpacks its key (no fallback)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("keyplane_bench: no CUDA device; --device cuda "
                         "needs one and does not fall back to the CPU")
    rec = run(PARAMS[os.environ.get("KB_PARAMS", "ieache_110_l2")],
              [int(x) for x in os.environ.get("KB_CLIENTS",
                                              "1,2,3").split(",")],
              int(os.environ.get("KB_ITERS", 3)), device,
              proc_clients=os.environ.get("KB_PROC_CLIENTS", "1") == "1",
              subproc=os.environ.get("KB_SUBPROC") == "1")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
