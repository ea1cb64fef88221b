"""The traced stretch read back: busy time, idle gaps by host span,
device time by kernel, the DP's roofline share."""

import pytest

from harness import core, devtrace, peaks


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("bench.stretch", "user_annotation", 1000.0, 1000.0),
    ev("bench.call", "user_annotation", 1000.0, 900.0),
    ev("pipeline.launch", "user_annotation", 1010.0, 90.0),
    ev("pipeline.finish", "user_annotation", 1400.0, 400.0),
    ev("void (anonymous namespace)::dp_ad_kernel<1, false, 26, false>("
       "(anonymous namespace)::Args)", "kernel", 1100.0, 300.0),
    ev("(anonymous namespace)::walk_kernel(unsigned char const*)", "kernel",
       1350.0, 100.0),
    ev("void at::native::elementwise_kernel<walk_kernel>()", "kernel",
       1100.0, 10.0),
    ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1440.0, 20.0),
    ev("bench.stretch", "gpu_user_annotation", 1000.0, 1000.0),
    ev("aten::copy_", "cpu_op", 1000.0, 5.0),
    # outside the stretch: not counted
    ev("void dp_ad_kernel<1, false, 26, false>(Args)", "kernel", 2500.0,
       300.0),
]


def test_summary_of_a_trace():
    s = devtrace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    # kernels 1100-1450 and the copy 1440-1460: busy 1100-1460
    assert s["busy_s"] == pytest.approx(360e-6)
    assert devtrace.device_seconds(s, "dp_ad_kernel") == pytest.approx(3e-4)
    assert devtrace.device_seconds(s, "walk_kernel") == pytest.approx(1e-4)
    # gaps: 1000-1100 (in pipeline.launch), 1460-2000 (mid 1730 in
    # pipeline.finish)
    assert s["idle_s"] == pytest.approx({"pipeline.launch": 100e-6,
                                         "pipeline.finish": 540e-6})
    b = devtrace.breakdown(s)
    assert "dp_ad_kernel<1" in b["device_ops"][0][0]
    assert b["idle_gaps"][0] == ["pipeline.finish", pytest.approx(540e-6)]
    assert devtrace.summarize(EVENTS[1:]) is None


def test_readers_of_the_trace():
    s = devtrace.summarize(EVENTS)
    s["calls"] = 2
    s["k1_rows"] = [(10 ** 9, 10_000, 10_000)]
    rec = {"calls": [], "window_s": 1.0, "setup_s": 1.0, "trace": s}
    ops, nbytes = core.load("counts", "dp_ad").work(s["k1_rows"], True)
    want = 100.0 * peaks.bound_s(nbytes, ops) / 3e-4
    assert core.load("metrics", "k1_roofline.extend").read(rec) == \
        pytest.approx(want)
    assert core.load("metrics", "walk_ms.extend").read(rec) == \
        pytest.approx(0.05)
    assert core.load("metrics", "device_idle_pct.extend").read(rec) == \
        pytest.approx(64.0)
    s["device_s"], s["device_events"] = {}, 0
    for name in ("k1_roofline.extend", "walk_ms.extend",
                 "device_idle_pct.extend"):
        assert core.load("metrics", name).read(rec) is None
