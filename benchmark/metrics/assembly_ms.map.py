"""assembly_ms.map: milliseconds a call of the program's
``blot.components`` span (each read's candidate boxes assembled on the
host: the sparse run merge at a 5 Mbp reference)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "blot.components")
