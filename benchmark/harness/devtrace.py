"""The traced stretch: a ``torch.profiler`` window over a few calls, read
back into device time by kernel, the device's busy time, and its idle
gaps by the host span that was open.

The program's host spans (``biseqt_tpu_torch.profiling.Phase``) are
mirrored into the profiler as ``record_function`` ranges while the
stretch runs, so that the trace places each idle gap in a span; the
harness adds ``bench.stretch`` around the stretch and ``bench.call``
around each call.  Device time is the union of kernel, memcpy and memset
intervals inside ``bench.stretch``.
"""

import contextlib
import json
import os
import re
import sys
import tempfile
import traceback

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "bench.stretch"
CALL = "bench.call"


@contextlib.contextmanager
def annotated_phases():
    """Open a profiler range named after each program span while it
    runs."""
    from biseqt_tpu_torch import profiling

    Phase = profiling.Phase
    enter, leave = Phase.__enter__, Phase.__exit__

    def _enter(self):
        self._bench_range = torch.profiler.record_function(self.name)
        self._bench_range.__enter__()
        return enter(self)

    def _exit(self, *exc):
        try:
            return leave(self, *exc)
        finally:
            self._bench_range.__exit__(None, None, None)

    Phase.__enter__, Phase.__exit__ = _enter, _exit
    try:
        yield
    finally:
        Phase.__enter__, Phase.__exit__ = enter, leave


def profile_calls(call, ks, on_card):
    """Run ``call(k)`` for each k of ``ks`` under the profiler; returns
    ``(outputs, summary)`` (:func:`summarize`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    outs = []
    with annotated_phases(), profile(activities=activities) as prof:
        with torch.profiler.record_function(STRETCH):
            for k in ks:
                with torch.profiler.record_function(CALL):
                    try:
                        outs.append((k, call(k)))
                    except Exception:  # judged as a failed call
                        outs.append((k, None))
                        print("traced call %d raised:\n%s"
                              % (k, traceback.format_exc()), file=sys.stderr)
            if on_card:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return outs, summarize(events)


def _union(iv):
    """Merged, sorted intervals of ``iv`` (a list of (start, end))."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events):
    """Read a Chrome trace's events: ``{"window_s", "busy_s",
    "device_s": {name: seconds}, "idle_s": {host span: seconds},
    "device_events"}``, or None when it holds no ``bench.stretch``."""
    xs = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in xs if e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        return None
    w0 = float(stretch[0]["ts"])
    w1 = w0 + float(stretch[0]["dur"])
    dev, device_s = [], {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        dev.append((s, t))
        name = e.get("name", "?")
        device_s[name] = device_s.get(name, 0.0) + (t - s) * 1e-6
    busy = _union(dev)
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < w1:
        gaps.append((at, w1))
    spans = [e for e in xs if e.get("cat") == "user_annotation"]
    starts = np.array([float(e["ts"]) for e in spans])
    ends = starts + np.array([float(e.get("dur", 0.0)) for e in spans])
    idle_s = {}
    for s, t in gaps:
        mid = (s + t) / 2
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = ("between spans" if not len(inside) else
                spans[inside[np.argmax(starts[inside])]]["name"])
        idle_s[name] = idle_s.get(name, 0.0) + (t - s) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "device_s": device_s, "idle_s": idle_s,
            "device_events": len(dev)}


def device_seconds(summary, prefix):
    """Device seconds of the operations whose function name starts with
    ``prefix`` (after any return type and namespaces: ``void
    (anonymous namespace)::dp_ad_kernel<1, ...>(Args)`` is a
    ``dp_ad_kernel``)."""
    if not summary:
        return 0.0
    total = 0.0
    for name, s in summary["device_s"].items():
        head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""),
                        maxsplit=1)[0]
        if re.split(r"[\s:]", head)[-1].startswith(prefix):
            total += s
    return total


def breakdown(summary, top=10):
    """The driver's ``breakdown``: the device operations that took most
    time, and the idle seconds by the host span open in each gap."""
    rank = lambda d: [[k[:120], v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(summary["device_s"]),
            "idle_gaps": rank(summary["idle_s"])}
