"""discover_ms.map: milliseconds a call of the program's ``map.discover``
span (the batch's Word-Blot discovery and each read's best segment)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "map.discover")
