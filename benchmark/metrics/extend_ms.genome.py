"""extend_ms.genome: milliseconds a call of the program's
``pipeline.extend`` span (the launches of the discovered segments'
windows and their finishing)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "pipeline.extend")
