"""Blind rotation, gadget decomposition, keyswitch and the CUDA kernels."""
