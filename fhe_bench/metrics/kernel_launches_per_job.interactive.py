"""Kernel launches a job: ``kernels.launch_counts()`` summed over the
step wrappers, its delta over the window's jobs."""


def read(record):
    jobs = [j for j in record["jobs"] if "launches" in j]
    return sum(j["launches"] for j in jobs) / len(jobs) if jobs else None
