"""The host's time a kernel launch in the blind rotation's dispatch:
Σ seconds of the window's ``blind_rotate`` spans over Σ the launches
they record (the step mode's wrappers' ``launches`` deltas), in µs."""

from fhe_bench.spans import dispatch_us_per_launch as read  # noqa: F401
