"""Empirical noise margin of the gate bootstrap, on the card.

Counterpart of ``tools/margin_probe.py``: bootstraps a batch of XOR
gates (the worst-case 2x linear combination at the next gate's input),
chains MP_ROUNDS of them (out XOR y), and measures each round's output
phase error (the phase, :func:`~ieache_tpu_torch.lwe.encrypt.phase_of`,
less ±1/8 of the torus) against the 1/16-torus failure threshold.
Prints one JSON line with the JAX tool's keys: the margin in σ
(threshold / (2·√2·σ) of the worst round), σ as a torus fraction, σ per
round, the decrypt errors over all rounds; and ``backend``,
``step_mode`` and ``card``.  Keys come from the device keygen.  Run
from the root of a checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.margin_probe

Env: MP_PARAMS (ieache_110_l2, the default; ieache_110;
ieache_110_tfhe_compat, tfhe-lib's gadget Bg = 2^10, l = 2, on split's
two-limb kernels; test_small_noisy), MP_BATCH (2048), MP_ROUNDS (4).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ieache_tpu_torch import params as P
from ieache_tpu_torch import prng
from ieache_tpu_torch.boot import bootstrap, gates
from ieache_tpu_torch.lwe import encrypt, keygen_device
from ieache_tpu_torch.tools._common import line_fields, require_cuda

#: MP_PARAMS names
PARAMS = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
          "ieache_110_tfhe_compat": P.IEACHE_110_TFHE_COMPAT,
          "test_small_noisy": P.TEST_SMALL_NOISY}


def xor_chain(ks, key, batch: int, rounds: int, device):
    """The probe's chain: yields (ciphertexts, wanted bits) per round."""
    stream = prng.key_from_seed_words([0x3A6])
    xb = prng.uniform_bits01(prng.derive(stream, 0), batch)
    yb = prng.uniform_bits01(prng.derive(stream, 1), batch)
    cx = encrypt.encrypt_bits_device(ks, xb, prng.derive(stream, 2), device)
    cy = encrypt.encrypt_bits_device(ks, yb, prng.derive(stream, 3), device)
    want = xb ^ yb
    out = gates.XOR(cx, cy, key)
    for r in range(rounds):
        yield out, want
        if r + 1 < rounds:  # keep chaining: out XOR y
            want = want ^ yb
            out = gates.XOR(out, cy, key)


def run(p, batch: int, rounds: int, device) -> dict:
    """The probe's record on ``device``."""
    ks = keygen_device.generate_secret_keyset_device(p, device)
    key = bootstrap.pack_cloud_key(ks.cloud, device)
    mu = bootstrap.MU
    errors = 0
    sigmas = []
    for out, want in xor_chain(ks, key, batch, rounds, device):
        ph = encrypt.phase_of(ks, out).astype(np.float64)
        err = np.where(want == 1, ph - mu, ph + mu)
        sigmas.append(float(err.std()))
        errors += int((encrypt.decrypt_bits(ks, out) != want).sum())

    sigma = max(sigmas)
    threshold = 2**32 / 16
    # the next gate's XOR combo 2(x - y) sums two independent outputs:
    # the conservative 2·√2 factor
    margin_sigma = threshold / (2 * np.sqrt(2) * sigma)
    return {
        "metric": "phase_noise_margin",
        "value": round(float(margin_sigma), 2),
        "unit": "sigma",
        "sigma_torus": round(sigma / 2**32, 6),
        "sigmas_per_round": [round(s / 2**32, 6) for s in sigmas],
        "batch": batch,
        "rounds": rounds,
        "errors": errors,
        "params": p.name,
        **line_fields(device),
    }


def main() -> int:
    device = require_cuda("margin_probe")
    p = PARAMS[os.environ.get("MP_PARAMS", "ieache_110_l2")]
    print(json.dumps(run(p, int(os.environ.get("MP_BATCH", 2048)),
                         int(os.environ.get("MP_ROUNDS", 4)), device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
