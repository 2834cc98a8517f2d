"""Ciphertexts bootstrapped a lane: Σ ``lanes`` of the window's
``bootstrap`` spans (one a wave of ``bootstrap_no_ks``) over the lanes
the window answered."""

from fhe_bench.spans import named


def read(record):
    boots = named(record.get("spans"), "bootstrap")
    lanes = sum(j["lanes"] for j in record["jobs"] if "seconds" in j)
    if not boots or not lanes:
        return None
    return sum(s["lanes"] for s in boots) / lanes
