"""The harness: one run of one cell, driven by ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the mix names its entry (``entries/<entry>.py``),
which makes the inputs from the seed, drives the program and judges its
outputs with the plain reference.  Each metric is read by
``metrics/<name>.py`` from the run's record.  A later cell or metric is
new files and a new entry in ``BENCHMARK.json``; no file here changes.

A run: set-up (the program imported, the inputs made, every shape of the
cell warmed up by one call of each batch of the pool), then a closed
loop of one caller for ``seconds``: a call that starts before the time is
up is finished, and the window ends when the last call returns.  Every
end-to-end metric is over all calls and all the time of that window.
With ``trace`` a profiled stretch of the mix's ``trace_calls`` calls
follows the window.  Then the judge holds every call's output to the
reference.
"""

import gc
import importlib.util
import json
import os
import sys
import time
import traceback

from harness import devtrace

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names that no run may have loaded: JAX, and the JAX
# package that the program under test was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "biseqt_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load(kind, name):
    """The module ``<kind>/<name>.py`` under the benchmark's folder."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    mod_name = "bench_%s_%s" % (kind, name.replace(".", "_"))
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return mod


def read_json(kind, name):
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def benchmark(path=None):
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench, name):
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit("no workload %r in BENCHMARK.json" % name)


def metrics_of(bench, cell, trace):
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


def forbidden_modules():
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def _window(entry, seconds, first_k, counters):
    """The closed loop: ``(calls, outputs, window seconds)``."""
    calls, outs = [], []
    k = first_k
    t_start = time.perf_counter()
    t_end = t_start
    while not calls or t_end - t_start < seconds:
        before = counters()
        t0 = time.perf_counter()
        try:
            out = entry.call(k)
        except Exception:  # judged as a failed call
            log("call %d raised:\n%s" % (k, traceback.format_exc()))
            out = None
        t_end = time.perf_counter()
        after = counters()
        spans = {n: v["seconds"] - before.get(n, {}).get("seconds", 0.0)
                 for n, v in after.items()
                 if v["calls"] != before.get(n, {}).get("calls", 0)}
        calls.append({"k": k, "latency_s": t_end - t0, "spans": spans})
        outs.append((k, out))
        # the outputs kept for the judge stay out of the collector's
        # scans, which would otherwise grow with the window
        gc.freeze()
        k += 1
    return calls, outs, t_end - t_start


def run_cell(bench, cell_name, seed, seconds, trace, device, t_process,
             config=None, traffic=None):
    """One run: ``(result dict, checks)``; ``checks`` maps each number
    compared to ``(value, limit)``.  ``config`` / ``traffic`` replace the
    cell's files (the tests' small sizes)."""
    import torch
    from biseqt_tpu_torch import profiling

    cell = cell_of(bench, cell_name)
    config = config or read_json("configs", cell["config"])
    traffic = traffic or read_json("traffic", cell["traffic"])
    on_card = torch.device(device).type == "cuda"
    entry = load("entries", traffic["entry"]).Entry(config, traffic, seed,
                                                    device)
    # every shape of the cell, once: each batch of the pool
    for k in range(len(entry)):
        entry.call(k)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process
    log("set-up %.3f s; window of %s s" % (setup_s, seconds))
    calls, outs, window_s = _window(entry, seconds, len(entry),
                                    profiling.counters)
    for c in calls:
        c["cells"] = entry.cells(c["k"])
    lat = sorted(1e3 * c["latency_s"] for c in calls)
    at = lambda q: lat[min(int(q * len(lat)), len(lat) - 1)]
    log("window %.3f s, %d calls; latency ms min %.3f p50 %.3f p90 %.3f"
        " p99 %.3f max %.3f" % (window_s, len(calls), lat[0], at(0.5),
                                at(0.9), at(0.99), lat[-1]))
    summary = None
    if trace:
        ks = range(calls[-1]["k"] + 1,
                   calls[-1]["k"] + 1 + int(traffic["trace_calls"]))
        traced, summary = devtrace.profile_calls(entry.call, ks, on_card)
        outs += traced
        if summary is not None:
            summary["calls"] = len(ks)
            summary["k1_rows"] = [r for k in ks for r in entry.k1_rows(k)]
    dev = {"platform": "gpu" if on_card else device, "count": 1}
    if on_card:
        dev["kind"] = torch.cuda.get_device_name(0)
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    else:
        dev["kind"] = "cpu"
        dev["memory_peak_bytes"] = 0
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    rec = {"calls": calls, "window_s": window_s, "setup_s": setup_s,
           "trace": summary}
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = load("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the program's cached blocks go before the reference runs
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks, failed = entry.judge(outs, device=device)
    log("judged %d calls in %.3f s" % (len(outs), time.perf_counter() - t0))
    result = {"correct": failed == 0 and all(
                  v <= lim for v, lim in checks.values()),
              "attempted": len(outs), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        result["breakdown"] = devtrace.breakdown(summary)
    return result, checks
