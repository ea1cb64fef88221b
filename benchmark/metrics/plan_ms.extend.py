"""plan_ms.extend: milliseconds a call of the program's ``pipeline.plan``
span (``extension_plan``: the plan of windows, cuts and launches)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "pipeline.plan")
