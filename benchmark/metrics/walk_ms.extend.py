"""walk_ms.extend: device milliseconds a traced call of the walk
kernel (``walk_kernel``)."""

from harness import readers


def read(rec):
    return readers.device_ms_per_call(rec, "walk_kernel")
