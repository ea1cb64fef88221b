"""compact_ms.extend: milliseconds a call of the program's
``pipeline.compact`` span (the C++ compaction of the walk's traces into
transcripts)."""

from harness import readers


def read(rec):
    return readers.span_ms(rec, "pipeline.compact")
