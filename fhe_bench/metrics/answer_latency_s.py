"""Mean answer latency: the sum of the window's job times on the
Output's side, over its jobs."""


def read(record):
    jobs = [j for j in record["jobs"] if "seconds" in j]
    if len(jobs) != len(record["jobs"]) or not jobs:
        return None
    return sum(j["seconds"] for j in jobs) / len(jobs)
