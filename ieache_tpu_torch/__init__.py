"""ieache_tpu_torch — the TFHE gate-bootstrapping core on PyTorch + CUDA.

The PyTorch port of :mod:`ieache_tpu` for an NVIDIA Hopper GPU (H100).
Module paths and function names mirror the JAX package, so each
function has a counterpart of the same name there; the JAX package is
the reference the port is held against, array for array (all
arithmetic is exact mod 2^32).

* public layouts are the JAX package's: LWE batches ``(B, n+1)``,
  accumulators ``(B, k+1, N)``, bootstrapping key ``(n, rows, k+1, N)``;
* the blind-rotation hot loop runs the CUDA kernels of the step mode
  ``IEACHE_PALLAS_STEP`` selects (``csrc/``, built with ``nvcc`` on
  first use by :mod:`ieache_tpu_torch.ops._build`) for tensors on a
  CUDA device, and their plain PyTorch twins for tensors on the CPU
  (:mod:`ieache_tpu_torch.ops.blind_rotate`);
* :mod:`ieache_tpu_torch.tools` holds the measurement tools, each run
  with ``python -m``;
* :mod:`ieache_tpu_torch.mp` and :mod:`ieache_tpu_torch.cli` are the
  six-role protocol and its CLI (``python -m ieache_tpu_torch.cli.main``),
  with the Cloud's evaluation on the device it is given;
* the host modules are the port's own copies, each pinned to its
  original by a CPU test and re-exported here: :mod:`.params`,
  :mod:`.utils.prng`, :mod:`.lwe.types`, :mod:`.lwe.keygen` and
  :mod:`.codec.files` (keys, streams and key files are identical
  across the two packages, byte for byte).

This package imports ``torch`` and never ``jax``, and nothing of
``ieache_tpu``.
"""

from ieache_tpu_torch import params  # noqa: F401
from ieache_tpu_torch.codec import files  # noqa: F401
from ieache_tpu_torch.lwe import keygen, types  # noqa: F401
from ieache_tpu_torch.utils import prng  # noqa: F401
