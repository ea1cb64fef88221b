"""serve_ms.map: milliseconds a call of the program's ``seeds.from_ref``
span (each read's seeds served on the host from the reference's
sorted k-mer table)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "seeds.from_ref")
