"""The window's arithmetic: whole calls, every call's latency in the
tail, band cells counted by the benchmark."""

import time

import pytest

import tiny
from harness import core, readers
from reference import cut as refcut


class Sleeper:
    """An entry whose call k sleeps ``waits[k % n]`` seconds and counts
    ``cells[k % n]`` band cells."""

    def __init__(self, waits, cells):
        self.waits, self.cell_counts = waits, cells

    def call(self, k):
        time.sleep(self.waits[k % len(self.waits)])
        return k

    def cells(self, k):
        return self.cell_counts[k % len(self.cell_counts)]


def no_spans():
    return {}


def test_a_call_started_in_time_is_finished():
    entry = Sleeper([0.05, 0.3], [10, 20])
    calls, outs, window_s = core._window(entry, 0.1, 0, no_spans)
    # call 0 (0.05 s) ends before 0.1 s, call 1 starts in time and runs
    # 0.3 s, and the window ends when it returns
    assert [c["k"] for c in calls] == [0, 1] == [k for k, _ in outs]
    assert window_s >= 0.35
    assert window_s == pytest.approx(sum(c["latency_s"] for c in calls),
                                     abs=0.01)
    assert "cells" not in calls[0]


def test_end_to_end_metrics_take_every_call():
    rec = {"calls": [{"latency_s": 0.001 * (i + 1), "cells": 10 ** 9,
                      "spans": {}} for i in range(100)],
           "window_s": 4.0, "setup_s": 3.0}
    assert core.load("metrics", "gcups").read(rec) == 25.0
    assert core.load("metrics", "call_s").read(rec) == 0.04
    # nearest rank: the 95th of 100 sorted latencies
    assert core.load("metrics", "call_p95_ms").read(rec) == \
        pytest.approx(95.0)
    assert readers.percentile_ms({"calls": rec["calls"][:1]}, 95) == \
        pytest.approx(1.0)
    assert core.load("metrics", "setup_s").read(rec) == 3.0


def test_spans_a_call():
    rec = {"calls": [{"latency_s": 0.5, "cells": 1,
                      "spans": {"pipeline.launch": 0.1,
                                "pipeline.finish": 0.2,
                                "pipeline.compact": 0.15}},
                     {"latency_s": 0.3, "cells": 1,
                      "spans": {"pipeline.launch": 0.1}}],
           "window_s": 0.8, "setup_s": 1.0}
    assert core.load("metrics", "dispatch_ms.extend").read(rec) == \
        pytest.approx(100.0)
    assert core.load("metrics", "compact_ms.extend").read(rec) == \
        pytest.approx(75.0)
    assert core.load("metrics", "prep_ms.extend").read(rec) == \
        pytest.approx(200.0)
    rec["calls"] = [dict(c, spans={}) for c in rec["calls"]]
    assert core.load("metrics", "dispatch_ms.extend").read(rec) is None


def test_cells_are_counted_from_the_segments_handed_over(monkeypatch):
    from biseqt_tpu_torch import pipeline

    entry = core.load("entries", "extend_segments").Entry(
        tiny.config(), tiny.traffic(), 9, "cpu")
    item = entry.items[0]
    want = sum((c[5] - c[4] + 1) * (c[1] - c[0]) for c in (
        refcut.cut_segment(sg["segment"], len(item["s"]), len(item["t"]))
        for sg in item["segments"]))
    assert entry.cells(0) == entry.cells(len(entry)) == want
    # the program's own count is not read: a program that reports other
    # band cells leaves the benchmark's count as it was
    real = pipeline.extend_segments
    monkeypatch.setattr(pipeline, "extend_segments", lambda *a, **kw: [
        dict(r, band_cells=1) for r in real(*a, **kw)])
    entry = core.load("entries", "extend_segments").Entry(
        tiny.config(), tiny.traffic(), 9, "cpu")
    entry.call(0)
    assert entry.cells(0) == want


def test_same_seed_same_inputs():
    a = core.load("entries", "extend_segments").Entry(
        tiny.config(), tiny.traffic(), 2 ** 31 + 5, "cpu")
    b = core.load("entries", "extend_segments").Entry(
        tiny.config(), tiny.traffic(), 2 ** 31 + 5, "cpu")
    c = core.load("entries", "extend_segments").Entry(
        tiny.config(), tiny.traffic(), 2 ** 31 + 6, "cpu")
    assert all((x["s"] == y["s"]).all() and x["segments"] == y["segments"]
               for x, y in zip(a.items, b.items))
    assert not (a.items[0]["s"][:100] == c.items[0]["s"][:100]).all()
