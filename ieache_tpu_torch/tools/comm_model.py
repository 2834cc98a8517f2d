"""Analytic multi-GPU communication model of the sharded bootstrap on
H100s.

Counterpart of ``tools/comm_model.py``, re-based on the NVIDIA H100:
nothing here is a TPU figure.  Per blind-rotation step (λ=110 l2:
N=1024, k+1=2, n=500 steps, int32 coefficients), the collectives per
parallelism axis are:

* ``dp`` (batch over GPUs): none per step; each GPU bootstraps its own
  lanes with a replicated key;
* ``tp`` (TRGSW rows and keyswitch contraction sharded): one
  all_reduce of the partial external product, (B_local, k+1, N) int32,
  a step (``ops/blind_rotate.py:external_product_step_sharded``), and
  one of (B_local, n+1) at the keyswitch;
* ``sp`` (polynomial axis sharded): one all_gather of the N-sharded
  accumulator a step (``dist/shard.py:_external_product_step_sp``).

The compute a step is the port's measured split step at B=1024
(``external_product`` 0.0934 ms + ``rot_diff_decompose`` 0.0040 ms,
PERF.md §6, ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W),
scaled by the batch share.  Collectives are modelled unoverlapped
(C=1: the all_reduce on the step's serial path) and overlapped by the
chunked schedule of ``blind_rotate_sharded(overlap_chunks=C)``:
T(C) = max(K + M/C, K/C + M) for compute K and communication M.

Bandwidths are NVIDIA's published figures (:data:`CITATIONS`), each
given as the bidirectional rate per GPU; a ring collective runs over
one direction of it (:data:`RING_FACTOR`) and moves 2(w-1)/w of the
payload a GPU for an all_reduce, (w-1)/w of the whole for an
all_gather.  Prints one JSON line.  No card is needed:

    python -m ieache_tpu_torch.tools.comm_model
"""

from __future__ import annotations

import json

#: the published figures behind each constant
CITATIONS = {
    "nvlink": "NVIDIA H100 Tensor Core GPU datasheet (SXM5): NVLink "
              "900 GB/s per GPU (fourth-generation NVLink, 18 links); "
              "DGX H100: 8 GPUs all-to-all through four NVSwitch chips",
    "pcie": "NVIDIA H100 datasheet: PCIe Gen5 128 GB/s per GPU (x16, "
            "both directions)",
    "ndr": "NVIDIA DGX H100 datasheet: 8x ConnectX-7 at 400 Gb/s "
           "InfiniBand NDR, one per GPU: 50 GB/s a direction, 100 GB/s "
           "both",
    "ring_factor": "ring collectives send over one direction of each "
                   "link; ring all_reduce moves 2(w-1)/w x bytes per GPU "
                   "(NCCL's bus-bandwidth accounting, nccl-tests "
                   "PERFORMANCE.md)",
    "measured_step": "PERF.md §6: external_product 0.0934 ms + "
                     "rot_diff_decompose 0.0040 ms a step at B=1024, "
                     "split, ieache_110_l2, NVIDIA H100 80GB HBM3 700 W "
                     "(chip_smoke.py)",
}

NVLINK_BPS = 900e9        # bytes/s per GPU, both directions (NVLink 4)
PCIE_BPS = 128e9          # bytes/s per GPU, both directions (Gen5 x16)
NDR_BPS = 100e9           # bytes/s per GPU, both directions (400 Gb/s NIC)
RING_FACTOR = 0.5         # one direction of the bidirectional rate
MEASURED_STEP_MS = 0.0934 + 0.0040   # B=1024, split, H100 700 W
MEASURED_B = 1024
N, KP1, NSTEPS, NP1 = 1024, 2, 500, 501
BYTES = 4

#: the fabric names of the rows, by bandwidth
FABRICS = {NVLINK_BPS: "nvlink", PCIE_BPS: "pcie", NDR_BPS: "ndr"}


def ring_allreduce_bytes(nbytes, ways):
    return 2 * (ways - 1) / ways * nbytes


def ring_allgather_bytes(local_bytes, ways):
    return (ways - 1) * local_bytes


def model(total_gpus, axis, ways, batch_per_gpu, overlap_chunks=1,
          link_bps=NVLINK_BPS):
    """-> dict with the bytes and time a step, and the projected
    efficiency and rate."""
    b = batch_per_gpu
    step_compute_ms = MEASURED_STEP_MS * b / MEASURED_B
    acc_bytes = b * KP1 * N * BYTES
    if axis == "dp":
        comm_bytes = 0.0
    elif axis == "tp":
        comm_bytes = ring_allreduce_bytes(acc_bytes, ways)
    elif axis == "sp":
        comm_bytes = ring_allgather_bytes(acc_bytes / ways, ways)
    else:
        raise ValueError(axis)
    comm_ms = comm_bytes / (link_bps * RING_FACTOR) * 1e3
    k, m, c = step_compute_ms, comm_ms, overlap_chunks
    step_ms = max(k + m / c, k / c + m) if c > 1 else k + m
    return {
        "axis": axis, "ways": ways, "gpus": total_gpus,
        "batch_per_gpu": b,
        "overlap_chunks": c,
        "fabric": FABRICS[link_bps],
        "step_compute_ms": round(step_compute_ms, 4),
        "comm_bytes_per_step": int(comm_bytes),
        "comm_ms_per_step": round(comm_ms, 4),
        "projected_efficiency": round(k / step_ms if step_ms else 1.0, 3),
        "projected_bootstraps_per_s_total": round(
            total_gpus * b / (NSTEPS * step_ms / 1e3), 1),
    }


def rows() -> list:
    out = []
    # dp at the bench batch a GPU: one DGX H100 (8) and two (16)
    for gpus in (8, 16):
        out.append(model(gpus, "dp", gpus, 1024))
    # tp within a node over NVLink, unoverlapped and chunked
    for gpus, tp in ((8, 2), (8, 4), (16, 2), (16, 4)):
        for c in (1, 2, 4):
            out.append(model(gpus, "tp", tp, 1024, overlap_chunks=c))
    # sp: the latency shape (B=8) and the throughput one
    for gpus, sp in ((8, 4), (16, 4)):
        out.append(model(gpus, "sp", sp, 8))
        out.append(model(gpus, "sp", sp, 1024))
    # cards on PCIe alone, and tp across nodes over NDR: why a per-step
    # axis stays on NVLink; dp across nodes needs no per-step traffic
    out.append(model(8, "tp", 2, 1024, overlap_chunks=4, link_bps=PCIE_BPS))
    out.append(model(16, "tp", 2, 1024, overlap_chunks=4, link_bps=NDR_BPS))
    out.append(model(16, "dp", 16, 1024, link_bps=NDR_BPS))
    return out


def run() -> dict:
    """The model's record."""
    tp_un = model(8, "tp", 2, 1024)["projected_efficiency"]
    tp_c2 = model(8, "tp", 2, 1024, 2)["projected_efficiency"]
    tp_c4 = model(8, "tp", 2, 1024, 4)["projected_efficiency"]
    tp_ndr = model(16, "tp", 2, 1024, 4, NDR_BPS)["projected_efficiency"]
    return {
        "probe": "comm_model_h100",
        "assumptions": {
            "nvlink_bytes_per_s_per_gpu": NVLINK_BPS,
            "pcie_bytes_per_s_per_gpu": PCIE_BPS,
            "ndr_bytes_per_s_per_gpu": NDR_BPS,
            "ring_factor": RING_FACTOR,
            "measured_step_ms_b1024": MEASURED_STEP_MS,
            "measured_on": "NVIDIA H100 80GB HBM3, 700.00 W",
            "overlap": "overlap_chunks=1 rows are the unoverlapped bound; "
                       "overlap_chunks=C rows the chunked schedule "
                       "T=max(K+M/C, K/C+M)",
            "params": "ieache_110_l2 (N=1024, k+1=2, n=500)",
            "citations": CITATIONS,
        },
        "rows": rows(),
        "conclusion": (
            "dp carries throughput with no per-step collective: 100% "
            "projected on NVLink and across nodes alike.  tp=2 on NVLink "
            f"projects {tp_un:.0%} unoverlapped and {tp_c2:.0%} / "
            f"{tp_c4:.0%} with the chunked all_reduce at C=2/4; across "
            f"nodes over NDR it drops to {tp_ndr:.0%} even overlapped, so "
            "tp and sp stay within an NVLink domain and are memory tools, "
            "not throughput ones, on a card that holds the whole key."),
    }


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
