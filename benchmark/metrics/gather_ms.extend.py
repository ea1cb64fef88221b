"""gather_ms.extend: milliseconds a call of the program's
``pipeline.gather`` span (``launch_inputs``: each launch's inputs cut
out of S and T)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "pipeline.gather")
