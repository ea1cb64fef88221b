"""Arithmetic shared by the metric readers (``metrics/<name>.py``).

Each reader takes the run's record: ``calls`` (one dict a call of the
window: ``latency_s``, ``cells`` counted by the benchmark, ``spans``: the
program's span seconds of that call), ``window_s``, ``setup_s`` and, in a
traced run, ``trace`` (:func:`harness.devtrace.summarize` of the profiled
stretch, with its ``calls`` and the DP's ``k1_rows``).  A reader that
finds nothing to read returns None and the metric is left out.
"""

import math

from harness import devtrace, peaks


def span_ms(rec, name):
    """Milliseconds a call of the program's span ``name``, over every call
    of the window; None when no call opened it."""
    calls = rec["calls"]
    if not any(name in c["spans"] for c in calls):
        return None
    return 1e3 * sum(c["spans"].get(name, 0.0) for c in calls) / len(calls)


def rest_ms(rec, names):
    """Milliseconds a call outside the spans ``names``: the call's wall
    less those spans, over every call of the window; None when no call
    opened them."""
    calls = rec["calls"]
    if not any(n in c["spans"] for c in calls for n in names):
        return None
    return 1e3 * sum(c["latency_s"] - sum(c["spans"].get(n, 0.0)
                                          for n in names)
                     for c in calls) / len(calls)


def percentile_ms(rec, q):
    """The nearest-rank ``q``-th percentile of every call's latency."""
    lat = sorted(c["latency_s"] for c in rec["calls"])
    return 1e3 * lat[max(math.ceil(q / 100 * len(lat)), 1) - 1]


def device_ms_per_call(rec, prefix):
    """Device milliseconds a traced call of the operations named
    ``prefix``; None without any."""
    tr = rec.get("trace")
    s = devtrace.device_seconds(tr, prefix)
    return 1e3 * s / tr["calls"] if s > 0 else None


def k1_roofline_pct(rec):
    """The DP's share of its roofline in the traced stretch: the least
    time its work could take (``counts/dp_ad.py``, ``peaks.py``) over the
    device time of ``dp_ad_kernel``."""
    from harness import core

    tr = rec.get("trace")
    s = devtrace.device_seconds(tr, "dp_ad_kernel")
    if s <= 0:
        return None
    ops, nbytes = core.load("counts", "dp_ad").work(tr["k1_rows"], True)
    return 100.0 * peaks.bound_s(nbytes, ops) / s


def step_mfu_pct(rec):
    """Percent of the card's float32 peak that the DP's work of every
    call of the window (with directions) would fill over the window."""
    from harness import core

    cells = sum(c["cells"] for c in rec["calls"])
    if not cells:
        return None
    ops = cells * core.load("counts", "dp_ad").OPS_PER_CELL[True]
    return 100.0 * ops / (rec["window_s"] * peaks.FP32_OPS_PER_S)


def idle_pct(rec):
    """Percent of the traced stretch in which no kernel, copy or memset
    ran on the device."""
    tr = rec.get("trace")
    if not tr or not tr["device_events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
