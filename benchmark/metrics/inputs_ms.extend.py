"""inputs_ms.extend: milliseconds a call of the program's
``dp_ad.inputs`` span (K1's host checks, band geometry and the inputs'
copies to the card)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "dp_ad.inputs")
