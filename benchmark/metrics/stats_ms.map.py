"""stats_ms.map: milliseconds a call of the program's ``blot.stats`` span
(p, S0 and S1 of every read's candidates in one call on the device, and
their copy back)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "blot.stats")
