"""The least time of the profiled job's bootstraps on the card, as
counted by its ``bootstrap`` spans (waves of the job's lanes; the
operations of their external products over the int8 peak, or their key
bytes over the HBM's, whichever is larger), as a share of the device
time of the operations launched inside its ``blind_rotate`` spans."""

from fhe_bench import roofline


def read(record):
    sliced = record.get("slice") or {}
    boots = sliced.get("bootstrapped")
    device = sliced.get("device_s_by_span", {}).get("blind_rotate")
    if not boots or not device:
        return None
    least = roofline.least_seconds(record["params"], boots, record["lanes"])
    return 100.0 * least / device
