"""Measurement tools of the port, each run with ``python -m``: the
evaluator's and the gate batch's (:mod:`~ieache_tpu_torch.tools.bench`,
:mod:`~ieache_tpu_torch.tools.margin_probe`,
:mod:`~ieache_tpu_torch.tools.width_bench`,
:mod:`~ieache_tpu_torch.tools.expr_bench`), the protocol's end to end
(:mod:`~ieache_tpu_torch.tools.e2e_bench`) and the kernels' and the
blind rotation's (:mod:`~ieache_tpu_torch.tools.step_bench`,
:mod:`~ieache_tpu_torch.tools.tile_bench`,
:mod:`~ieache_tpu_torch.tools.profile_gate`,
:mod:`~ieache_tpu_torch.tools.transposed_probe`,
:mod:`~ieache_tpu_torch.tools.mosaic_mm_probe`)."""
