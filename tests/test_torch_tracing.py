"""The port's own tracing (biseqt_tpu_torch.profiling): spans that are
profiler ranges while a torch profiler records, the spans that split
extension and discovery into their parts, counts under the innermost
span, and the benchmark's mirroring of spans into its traced stretch
composed with the program's own ranges.  CPU only: the counts of
launches and bytes on the card are held in tests/test_torch_cuda.py."""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from biseqt_tpu_torch import blot, profiling
from biseqt_tpu_torch.pipeline import extend_segments, map_reads
from biseqt_tpu_torch.sequence import Alphabet, Sequence

A4 = Alphabet("ACGT")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTEND_SPANS = ("pipeline.plan", "pipeline.extend", "pipeline.gather",
                "pipeline.launch", "dp_ad.inputs", "pipeline.finish",
                "pipeline.wait", "pipeline.compact", "pipeline.rows")
# (inner, outer): each range of the inner span lies in one of the outer's
NESTED = [("pipeline.wait", "pipeline.finish"),
          ("dp_ad.inputs", "pipeline.launch"),
          ("pipeline.gather", "pipeline.extend"),
          ("pipeline.launch", "pipeline.extend"),
          ("pipeline.compact", "pipeline.finish")]


@pytest.fixture
def pair():
    """One planted 150-letter block with 10% substitutions and its
    segment: one launch."""
    rng = np.random.default_rng(20)
    core = rng.integers(0, 4, 150)
    mut = core.copy()
    hit = rng.random(150) < 0.1
    mut[hit] = (mut[hit] + 1 + rng.integers(0, 3, hit.sum())) % 4
    S = Sequence(A4, np.concatenate([rng.integers(0, 4, 60), core]))
    T = Sequence(A4, np.concatenate([rng.integers(0, 4, 40), mut]))
    return S, T, [{"segment": ((12, 28), (100, 400))}]


def extend(pair):
    S, T, segments = pair
    return extend_segments(S, T, segments, device="cpu",
                           with_transcripts=True, _r_chunk=16)


def ranges(events):
    """``{name: [(start, end), ...]}`` of the trace's user ranges."""
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            t = float(e["ts"])
            out.setdefault(e["name"], []).append((t, t + float(e["dur"])))
    return out


def traced(fn, tmp_path):
    """``fn()`` under a CPU profiler: ``(its result, the trace's
    events)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, json.load(f)["traceEvents"]


def opened(fn):
    """``fn()`` and the spans it opened (their calls since before)."""
    before = profiling.counters()
    out = fn()
    return out, {name: v["calls"] - before.get(name, {}).get("calls", 0)
                 for name, v in profiling.counters().items()
                 if v["calls"] != before.get(name, {}).get("calls", 0)}


def test_extension_opens_its_parts_and_they_nest(pair, tmp_path):
    """Without a profiler extension opens plan, gather, inputs, wait and
    rows as spans; under one every span is a range, the parts nested in
    their parents and plan and rows outside ``pipeline.extend``."""
    rows, spans = opened(lambda: extend(pair))
    assert all(spans.get(name, 0) >= 1 for name in EXTEND_SPANS), spans
    assert spans["pipeline.plan"] == spans["pipeline.rows"] == 1
    got, events = traced(lambda: extend(pair), tmp_path)
    assert got == rows and rows[0]["score"] > 50
    have = ranges(events)
    for name in EXTEND_SPANS:
        assert len(have[name]) == spans[name], name
    inside = lambda r, outer: any(s <= r[0] and r[1] <= e
                                  for s, e in have[outer])
    for inner, outer in NESTED:
        assert all(inside(r, outer) for r in have[inner]), (inner, outer)
    for name in ("pipeline.plan", "pipeline.rows"):
        (r,) = have[name]
        assert not inside(r, "pipeline.extend") and inside(r, name)


@pytest.mark.parametrize("assembler", ["dense", "sparse"])
def test_discovery_opens_its_parts(monkeypatch, assembler):
    """Word-Blot opens the seeds' fetch, and the candidates' assembly on
    either assembler; the dense one builds the grid first, the sparse
    one has none, and counts under the assembly the runs it merges and
    the boxes whose seeds it counts, one a candidate it returns."""
    rng = np.random.default_rng(7)
    core = rng.integers(0, 4, 3000)
    mut = core.copy()
    hit = rng.random(3000) < 0.05
    mut[hit] = (mut[hit] + 1 + rng.integers(0, 3, hit.sum())) % 4
    S = Sequence(A4, np.concatenate([rng.integers(0, 4, 500), core]))
    T = Sequence(A4, np.concatenate([rng.integers(0, 4, 200), mut]))
    if assembler == "sparse":
        monkeypatch.setattr(blot.WordBlot, "MAX_GRID_CELLS", 1)
    wb, spans = opened(lambda: blot.WordBlot(S, T, wordlen=8, g_max=0.1,
                                             device="cpu"))
    assert spans == {"seeds.build": 1, "seeds.fetch": 1}
    counted0 = profiling.counts().get("blot.components", {})
    segs, spans = opened(lambda: list(wb.similar_segments(K_min=500,
                                                          p_min=0.6)))
    assert len(segs) == 1 and segs[0]["num_seeds"] > 1000
    want = {"blot.discover": 1, "blot.components": 1, "blot.stats": 1}
    if assembler == "dense":
        want["blot.grid"] = 1
    assert spans == want
    grew = {k: v - counted0.get(k, 0) for k, v in
            profiling.counts().get("blot.components", {}).items()
            if v != counted0.get(k, 0)}
    if assembler == "sparse":
        assert set(grew) == {"blot.runs", "blot.counted"}
        assert grew["blot.counted"] == len(wb._candidates(500, 0.6)) >= 1
        assert grew["blot.runs"] >= grew["blot.counted"]
    else:
        assert grew == {}


def test_mapping_opens_its_parts_and_counts_its_work(tmp_path):
    """``map_reads`` opens ``map.discover`` and ``map.extend`` once a call,
    each read's ``seeds.from_ref`` inside the first and the extension
    inside the second, and counts the reads and the unmapped ones under
    ``map.discover``, the seeds served under ``seeds.from_ref`` and the
    candidates of the one statistics call under ``blot.stats``."""
    rng = np.random.default_rng(24)
    ref = rng.integers(0, 4, 8000)
    reads = []
    for r0 in (500, 4000):
        core = ref[r0:r0 + 600].copy()
        hit = rng.random(600) < 0.05
        core[hit] = (core[hit] + 1 + rng.integers(0, 3, hit.sum())) % 4
        reads.append(Sequence(A4, core))
    # shorter than K_min: no candidate, unmapped
    reads.append(Sequence(A4, rng.integers(0, 4, 100)))
    mapper = blot.WordBlotLocalRef(Sequence(A4, ref), wordlen=8, g_max=0.1,
                                   device="cpu")
    wbs = [mapper._as_wordblot(blot.WordBlot, r) for r in reads]
    served = sum(len(wb.seed_index.seed_arrays()[0]) for wb in wbs)
    candidates = sum(len(wb._candidates(200, 0.6)) for wb in wbs)
    assert served > 500 and candidates >= 2
    call = lambda: map_reads(mapper, reads, K_min=200, p_min=0.6,
                             with_transcripts=True, device="cpu")
    counted0 = profiling.counts()
    out, spans = opened(call)
    assert [o["best"] is None for o in out] == [False, False, True]
    assert spans["map.discover"] == spans["map.extend"] == 1
    assert spans["seeds.from_ref"] == 3 and spans["pipeline.extend"] == 1
    grew = lambda span, key: profiling.counts()[span][key] - counted0.get(
        span, {}).get(key, 0)
    assert grew("map.discover", "map.reads") == 3
    assert grew("map.discover", "map.unmapped") == 1
    assert grew("seeds.from_ref", "seeds.served") == served
    assert grew("blot.stats", "blot.candidates") == candidates
    got, events = traced(call, tmp_path)
    assert got == out
    have = ranges(events)
    assert len(have["map.discover"]) == len(have["map.extend"]) == 1
    inside = lambda r, outer: any(s <= r[0] and r[1] <= e
                                  for s, e in have[outer])
    assert len(have["seeds.from_ref"]) == 3
    for inner, outer in (("seeds.from_ref", "map.discover"),
                         ("blot.stats", "map.discover"),
                         ("pipeline.plan", "map.extend"),
                         ("pipeline.extend", "map.extend")):
        assert all(inside(r, outer) for r in have[inner]), (inner, outer)


class CountingRange:
    """A stand-in for ``record_function`` that counts what it opens."""
    opened = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingRange.opened.append(self.name)
        return self

    def __exit__(self, *exc):
        return False


def test_phase_opens_a_range_only_under_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    monkeypatch.setattr(CountingRange, "opened", [])
    with profiling.Phase("unit.quiet"):
        with profiling.Phase("unit.quiet.inner"):
            pass
    assert CountingRange.opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.Phase("unit.loud"):
            with profiling.Phase("unit.loud.inner"):
                pass
    assert CountingRange.opened == ["unit.loud", "unit.loud.inner"]


def test_counts_land_under_the_innermost_span():
    profiling.report(reset=True)
    profiling.count("unit.events")
    with profiling.Phase("unit.outer"):
        profiling.count("unit.events", 2)
        with profiling.Phase("unit.inner", cells=10 ** 9):
            profiling.count("unit.events", 3)
            profiling.count("unit.bytes", 40)
        profiling.count("unit.bytes", 7)
    with pytest.raises(RuntimeError):
        with profiling.Phase("unit.raises"):
            raise RuntimeError
    profiling.count("unit.events")
    # a tensor on the host is no copy between the host and a card
    profiling.host_copy(torch.ones(4))
    assert profiling.counts() == {
        profiling.NO_SPAN: {"unit.events": 2},
        "unit.outer": {"unit.events": 2, "unit.bytes": 7},
        "unit.inner": {"unit.events": 3, "unit.bytes": 40}}
    assert profiling.total("unit.events") == 7
    assert profiling.total("unit.bytes") == 47
    assert profiling.total("unit.none") == 0
    assert all(set(v) == {"calls", "seconds", "cells"}
               for v in profiling.counters().values())
    assert set(profiling.counters()) == {"unit.outer", "unit.inner",
                                         "unit.raises"}
    rows = {r["phase"]: r for r in map(json.loads, profiling.report(
        reset=True).splitlines())}
    assert rows[profiling.NO_SPAN] == {"phase": profiling.NO_SPAN,
                                       "counts": {"unit.events": 2}}
    assert rows["unit.inner"]["counts"] == {"unit.bytes": 40,
                                            "unit.events": 3}
    assert rows["unit.inner"]["calls"] == 1 and "gcups" in rows["unit.inner"]
    assert "counts" not in rows["unit.raises"]
    assert profiling.counts() == {} and profiling.counters() == {}


def test_first_load_is_a_span_and_each_build_is_counted(monkeypatch,
                                                        tmp_path):
    """``_build.load``: the first load of a library in the process opens
    ``build.load``, and nvcc's run under it counts one ``builds``; a
    library on disk is opened without a build, and a loaded one opens no
    span."""
    from biseqt_tpu_torch import _build

    def nvcc(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("built")
        return type("Done", (), {"returncode": 0, "stdout": ""})()

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_paths", lambda name: (
        name + ".cu", str(tmp_path / (name + ".so")),
        str(tmp_path / (name + ".log"))))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: SimpleNamespace(
        bst_cuda_error_string=SimpleNamespace()))
    monkeypatch.setattr(_build, "_LIBS", {})
    before = profiling.counts().get("build.load", {}).get("builds", 0)
    for name, want in (("unit_a", {"build.load": 1}), ("unit_a", {}),
                       ("unit_b", {"build.load": 1})):
        _, spans = opened(lambda: _build.load(name, lambda lib: None))
        assert spans == want, name
    assert profiling.counts()["build.load"]["builds"] - before == 2
    monkeypatch.setattr(_build, "_LIBS", {})
    _, spans = opened(lambda: _build.load("unit_a", lambda lib: None))
    assert spans == {"build.load": 1}
    assert profiling.counts()["build.load"]["builds"] - before == 2


def test_benchmark_mirror_composes_with_the_programs_ranges(pair,
                                                            monkeypatch):
    """The benchmark's traced stretch mirrors each span into a range of
    its own (``devtrace.annotated_phases``): with the program's ranges
    each span is two nested ranges of one name, and an idle gap inside
    any span is given to that span's name."""
    spec = importlib.util.spec_from_file_location(
        "bench_devtrace", os.path.join(REPO, "benchmark", "harness",
                                       "devtrace.py"))
    devtrace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(devtrace)
    seen = []
    summarize = devtrace.summarize
    monkeypatch.setattr(devtrace, "summarize",
                        lambda events: seen.append(events) or
                        summarize(events))
    _, spans = opened(lambda: devtrace.profile_calls(
        lambda k: extend(pair), [0], False))
    (events,) = seen
    have = ranges(events)
    for name in EXTEND_SPANS:
        assert len(have[name]) == 2 * spans[name], name
    # the device busy all through the stretch but for a short gap in
    # each span, before its first nested range: every gap is named
    (w0, w1), = have[devtrace.STRETCH]
    starts = sorted(s for rs in have.values() for s, _ in rs)
    points = []
    for name in EXTEND_SPANS:
        s, e = max(have[name])          # the later of a span's two ranges
        nxt = min([t for t in starts if s < t < e] + [e])
        points.append((name, (s + nxt) / 2))
    busy, at = [], w0
    for _, p in sorted(points, key=lambda x: x[1]):
        busy.append({"ph": "X", "cat": "kernel", "name": "k", "ts": at,
                     "dur": p - 0.01 - at})
        at = p + 0.01
    busy.append({"ph": "X", "cat": "kernel", "name": "k", "ts": at,
                 "dur": w1 - at})
    idle = summarize(events + busy)["idle_s"]
    assert set(idle) == set(EXTEND_SPANS)


def test_spans_and_counts_from_many_threads_are_all_kept():
    """Spans close and counts land from threads at once (the smoke builds
    its kernels in parallel): no update is lost, and each thread's
    counts land under its own innermost span."""
    import sys
    import threading

    n_threads, n_spans = 8, 500
    timed0, counted0 = profiling.counters(), profiling.counts()

    def work():
        for _ in range(n_spans):
            with profiling.Phase("unit.thread", cells=1):
                profiling.count("unit.events")
                with profiling.Phase("unit.thread.inner"):
                    profiling.count("unit.events", 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_spans

    def grew(now, then, span, key):
        return now[span][key] - then.get(span, {}).get(key, 0)

    timed, counted = profiling.counters(), profiling.counts()
    assert grew(timed, timed0, "unit.thread", "calls") == total
    assert grew(timed, timed0, "unit.thread", "cells") == total
    assert grew(timed, timed0, "unit.thread.inner", "calls") == total
    assert grew(counted, counted0, "unit.thread", "unit.events") == total
    assert grew(counted, counted0, "unit.thread.inner",
                "unit.events") == 2 * total
