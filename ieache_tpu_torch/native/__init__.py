"""The port's binding to the C++ oracle (:mod:`~ieache_tpu_torch.native.lib`)."""
