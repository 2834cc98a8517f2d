"""The least time of the profiled job's bootstraps on the card, by the
limb products their gadget needs (:mod:`fhe_bench.limbs`: 7 (digit limb,
key limb) pairs a product where a digit takes two int8 limbs, 4 where
one) or their key bytes, whichever is larger, in waves of the job's
lanes, as a share of the device's busy time over that job."""

from fhe_bench import limbs


def read(record):
    sliced = record["slice"]
    if not sliced or not sliced.get("boots") or not sliced["busy_s"]:
        return None
    least = limbs.least_seconds(record["params"], sliced["boots"],
                                record["lanes"])
    return 100.0 * least / sliced["busy_s"]
