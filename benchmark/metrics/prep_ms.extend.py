"""prep_ms.extend: milliseconds a call outside ``pipeline.launch``
and ``pipeline.finish``: planning, the input gather and building the
output rows on the host."""

from harness import readers


def read(rec):
    return readers.rest_ms(rec, ("pipeline.launch", "pipeline.finish"))
