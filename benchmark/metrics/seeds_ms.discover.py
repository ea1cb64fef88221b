"""seeds_ms.discover: milliseconds a call of the program's
``seeds.build`` span (the seed join on the device and its copy to the
host)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "seeds.build")
