"""The least time of the profiled job's bootstraps on the card (the
operations of their external products over the int8 peak, or their key
bytes over the HBM's, whichever is larger; waves of the job's lanes),
as a share of the device's busy time over that job.  The keyswitch's
additions are not counted."""

from fhe_bench import roofline


def read(record):
    sliced = record["slice"]
    if not sliced or not sliced["boots"]:
        return None
    least = roofline.least_seconds(record["params"], sliced["boots"],
                                   record["lanes"])
    return 100.0 * least / sliced["busy_s"]
