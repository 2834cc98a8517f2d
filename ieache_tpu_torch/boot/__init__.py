"""Gate bootstrapping and the batched gate API (PyTorch)."""
