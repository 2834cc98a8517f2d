"""The device's idle share over the profiled job: one less the union
of its operations' intervals over the job's wall time."""

from fhe_bench.metrics_common import idle_share as read  # noqa: F401
