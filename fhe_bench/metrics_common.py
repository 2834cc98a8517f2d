"""Arithmetic that more than one metric's reader shares."""


def idle_share(record):
    """Percent of the profiled slice's wall time in which no operation
    ran on the device; None without a profiled slice."""
    sliced = record["slice"]
    if not sliced:
        return None
    return 100.0 * (1.0 - sliced["busy_s"] / sliced["wall_s"])
