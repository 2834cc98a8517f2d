"""Measurement tools of the port, each run with ``python -m``:
:mod:`~ieache_tpu_torch.tools.transposed_probe` and
:mod:`~ieache_tpu_torch.tools.step_bench`."""
