"""fetch_ms.discover: milliseconds a call of the program's
``seeds.fetch`` span (the sorted seeds joined and copied to pageable
host memory)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "seeds.fetch")
