"""rows_ms.extend: milliseconds a call of the program's ``pipeline.rows``
span (the output rows built after the launches)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "pipeline.rows")
