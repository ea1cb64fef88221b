"""wait_ms.genome: milliseconds a call of the program's ``pipeline.wait``
span (the host blocked on each launch's event)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "pipeline.wait")
