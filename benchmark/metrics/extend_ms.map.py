"""extend_ms.map: milliseconds a call of the program's ``map.extend`` span
(the reads' best segments extended together: plan, launches and their
finishing, rows)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "map.extend")
