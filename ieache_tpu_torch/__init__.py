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
* the jax-free host modules of the JAX package are reused as they are,
  and re-exported here so that a caller of the port names one package:
  :mod:`ieache_tpu.params`, :mod:`ieache_tpu.utils.prng`,
  :mod:`ieache_tpu.lwe.types`, :mod:`ieache_tpu.lwe.keygen` and
  :mod:`ieache_tpu.codec.files` (keys, streams and key files are then
  identical across the two backends).

This package imports ``torch`` and never ``jax``.
"""

from ieache_tpu import params  # noqa: F401
from ieache_tpu.codec import files  # noqa: F401
from ieache_tpu.lwe import keygen, types  # noqa: F401
from ieache_tpu.utils import prng  # noqa: F401
