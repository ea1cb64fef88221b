"""compact_kernel_ms.extend: device milliseconds a traced call of the
compaction kernel (``compact_kernel``), which turns the walk's op trace
into transcripts on the card; None where the program has no such
kernel."""

from harness import readers


def read(rec):
    return readers.device_ms_per_call(rec, "compact_kernel")
