"""device_idle_pct.map: percent of the traced stretch in which the device
ran no kernel, copy or memset."""

from harness import readers


def read(rec):
    return readers.idle_pct(rec)
