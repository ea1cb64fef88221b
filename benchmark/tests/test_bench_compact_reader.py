"""The reader of the compaction kernel's device time
(``compact_kernel_ms.extend``): milliseconds a traced call of
``compact_kernel``, and nothing where the program has no such kernel."""

import pytest

from harness import core, devtrace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_compact_kernel_ms_reads_its_kernel_alone():
    events = [
        ev("bench.stretch", "user_annotation", 1000.0, 1000.0),
        ev("(anonymous namespace)::compact_kernel(unsigned char const*, "
           "int)", "kernel", 1100.0, 60.0),
        ev("(anonymous namespace)::walk_kernel(unsigned char const*)",
           "kernel", 1200.0, 100.0),
        ev("(anonymous namespace)::compact_kernel(unsigned char const*, "
           "int)", "kernel", 1500.0, 20.0),
    ]
    s = devtrace.summarize(events)
    s["calls"] = 2
    rec = {"calls": [], "window_s": 1.0, "setup_s": 1.0, "trace": s}
    metric = core.load("metrics", "compact_kernel_ms.extend")
    assert metric.read(rec) == pytest.approx(0.04)
    s["device_s"] = {k: v for k, v in s["device_s"].items()
                     if "compact" not in k}
    assert metric.read(rec) is None
    assert metric.read({"calls": [], "trace": None}) is None
