"""dispatch_ms.extend: milliseconds a call of the program's
``pipeline.launch`` span (the dispatch of each launch: K1, the walk and
the copies enqueued)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "pipeline.launch")
