"""components_ms.discover: milliseconds a call of the program's
``blot.components`` span (the candidates assembled on the host:
labels, boxes and their seed counts)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "blot.components")
