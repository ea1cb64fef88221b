"""grid_ms.discover: milliseconds a call of the program's ``blot.grid``
span (the seeds bucketed, the grid and its 3x3 sums on the device and
both copied back)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "blot.grid")
