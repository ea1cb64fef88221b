"""setup_s: seconds from the start of the process to the first timed
call (import, CUDA context, kernel load or build, inputs, warm-up)."""


def read(rec):
    return rec["setup_s"]
