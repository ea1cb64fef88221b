"""call_p95_ms: the 95th percentile (nearest rank) of the latency of
every call of the window, from the call to its return with its outputs
on the host."""

from harness import readers


def read(rec):
    return readers.percentile_ms(rec, 95)
