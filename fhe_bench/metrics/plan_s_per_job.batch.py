"""The evaluator's host planning a job: Σ seconds of the window's
``evaluator.plan`` (metadata decrypted, masks uploaded) and
``evaluator.finish`` (the answer's metadata encrypted) spans over the
window's jobs."""

from fhe_bench.spans import named


def read(record):
    spans = record.get("spans")
    plans = named(spans, "evaluator.plan") + named(spans, "evaluator.finish")
    if not plans or not record["jobs"]:
        return None
    return sum(s["seconds"] for s in plans) / len(record["jobs"])
