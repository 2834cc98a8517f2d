"""Bootstraps a lane: the evaluator's ``gate_count`` delta over the
lanes the window answered (an accounting formula of the program, not a
count of ciphertexts bootstrapped)."""


def read(record):
    jobs = [j for j in record["jobs"] if "boots" in j]
    lanes = sum(j["lanes"] for j in jobs)
    return sum(j["boots"] for j in jobs) / lanes if lanes else None
