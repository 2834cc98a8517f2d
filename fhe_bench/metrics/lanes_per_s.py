"""Expression lanes answered in the window over the time from its start
to the end of its last job."""


def read(record):
    return sum(j.get("lanes", 0) for j in record["jobs"] if "seconds" in j) \
        / record["window_s"]
