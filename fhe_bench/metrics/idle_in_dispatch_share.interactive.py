"""Percent of the profiled job's device idle time that passed under a
``blind_rotate`` span, the innermost span open while the device
waited."""

from fhe_bench.spans import idle_in_dispatch_share as read  # noqa: F401
