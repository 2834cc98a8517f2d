"""The port's command-line interface: ``python -m ieache_tpu_torch.cli.main``."""
