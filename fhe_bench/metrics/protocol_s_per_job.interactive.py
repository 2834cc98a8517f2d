"""The protocol's seconds a job: the Output's job time less the Cloud's
computation span of that job, averaged over the window's jobs."""


def read(record):
    jobs = [j for j in record["jobs"] if "compute_s" in j]
    if not jobs:
        return None
    return sum(j["seconds"] - j["compute_s"] for j in jobs) / len(jobs)
