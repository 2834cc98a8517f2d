"""Set-up: from the process's start to the first timed job (library
load or build, device keygen, operand pool or key plane, warm-up)."""


def read(record):
    return record["setup_s"]
