"""discover_ms.genome: milliseconds a call of the program's
``blot.discover`` span (the grid, its components on the host and the
statistics on the device)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "blot.discover")
