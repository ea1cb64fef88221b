"""Profiling / observability: phase timers and GCUPS counters.

The port's counterpart of :mod:`biseqt_tpu.profiling`.  ``Phase``
timers aggregate into a process-wide registry that :func:`report`
prints as JSON lines.  CUDA launches return before the card finishes,
so honest wall-clock needs a synchronisation inside the timed region:
``Phase`` takes an optional ``result`` and synchronises the devices of
the CUDA tensors in it before the timer stops.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import time
from collections import defaultdict

import torch

__all__ = ["Phase", "counters", "report", "gcups", "cuda_ms", "bound_ms",
           "materialize", "sass_step_loop", "cuobjdump_sass", "trace",
           "HBM_BYTES_PER_S", "FP32_OPS_PER_S", "INT32_OPS_PER_S"]

_REGISTRY = defaultdict(lambda: {"calls": 0, "seconds": 0.0, "cells": 0})


class Phase:
    """Timer context: ``with Phase('extend', cells=n) as ph: ...``.

    ``cells`` accumulates DP-cell counts so :func:`report` can derive
    GCUPS per phase.  For honest device timing, either synchronise
    inside the block yourself or hand the phase its results
    (``ph.result = out``): the devices they live on are then
    synchronised before the timer stops.
    """

    def __init__(self, name: str, cells: int = 0, result=None):
        self.name = name
        self.cells = int(cells)
        self.result = result

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.result is not None and exc[0] is None:
            materialize(self.result)
        dt = time.perf_counter() - self.t0
        entry = _REGISTRY[self.name]
        entry["calls"] += 1
        entry["seconds"] += dt
        entry["cells"] += self.cells
        return False


def materialize(x):
    """Wait until the CUDA work behind every tensor in ``x`` (a tensor
    or a nest of lists, tuples and dicts) is done; returns ``x``."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for u in v.values():
                visit(u)
        elif isinstance(v, (list, tuple)):
            for u in v:
                visit(u)

    visit(x)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return x


def gcups(cells: int, seconds: float) -> float:
    return cells / max(seconds, 1e-12) / 1e9


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet and Hopper white paper): 3.35 TB/s of HBM3; 67 TFLOP/s of
# float32 outside the tensor cores, an FMA counted as two, i.e. 33.5 T
# float instructions a second (132 SMs x 128 FP32 lanes x 1.98 GHz);
# 64 INT32 lanes per SM, so half that for 32-bit integer instructions.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
INT32_OPS_PER_S = 16.75e12


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    """The least time the card could take for work that moves ``nbytes``
    to or from device memory and does ``ops`` operations at
    ``ops_per_s``: ``(ms, "bytes" or "operations")``, whichever bound
    is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


L2_BYTES = 50 << 20


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Mean milliseconds of ``fn()`` on the current CUDA device over
    ``reps`` runs, by CUDA events, after one warm-up run.  ``cold``
    writes twice the L2 cache's size before each run, outside the timed
    span, so that each run finds its inputs in device memory."""
    fn()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    scrub = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    spans = []
    for _ in range(reps):
        scrub.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / reps


_SASS_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_SASS_BRA = re.compile(r"\bBRA\b[^;]*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def sass_step_loop(sass: str, function: str, barrier: bool = True):
    """The step loop of a kernel in ``cuobjdump -sass`` output: the
    instructions from the target of its back-branch to the branch, in
    the first function whose mangled name contains ``function``.  The
    step loop is the longest backward branch span that holds a block
    barrier (any span, for a kernel whose loop has none, with
    ``barrier=False``).  Returns ``{"function", "instructions",
    "barriers", "spills"}`` (a loop unrolled by n holds n barriers;
    ``spills`` has one entry per local-memory load or store, ``LDL`` /
    ``STL``, of the function: the instructions of the shortest loop that
    holds it, 0 outside every loop), or None when no such loop is
    found."""
    name, insns, addrs, labels = None, [], {}, {}
    for line in sass.splitlines():
        m = _SASS_FUNCTION.search(line)
        if m:
            if name is not None:
                break
            if function in m.group(1):
                name = m.group(1)
            continue
        if name is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            labels[m.group(1)] = len(insns)
            continue
        m = _SASS_INSN.search(line)
        if m:
            addrs[int(m.group(1), 16)] = len(insns)
            insns.append(m.group(2).strip())
    best, loops = None, []
    for b, insn in enumerate(insns):
        m = _SASS_BRA.search(insn)
        if not m:
            continue
        t = labels.get(m.group(1)) if m.group(1) else addrs.get(
            int(m.group(2), 16))
        if t is None or t > b:
            continue
        span = insns[t:b + 1]
        loops.append((t, b))
        bars = sum(1 for x in span
                   if re.match(r"(@!?U?P\w+\s+)?BAR\.SYNC", x))
        if (bars or not barrier) and (best is None
                                      or len(span) > best["instructions"]):
            best = {"function": name, "instructions": len(span),
                    "barriers": bars}
    if best is not None:
        best["spills"] = [
            min((b - t + 1 for t, b in loops if t <= x <= b), default=0)
            for x, insn in enumerate(insns)
            if re.match(r"(@!?U?P\w+\s+)?(LDL|STL)\b", insn)]
    return best


def cuobjdump_sass(so_path: str) -> str:
    """``cuobjdump -sass`` of a built library (the CUDA toolkit's
    cuobjdump beside nvcc)."""
    from . import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", so_path], check=True,
                          capture_output=True, text=True, timeout=120).stdout


def counters() -> dict:
    return {k: dict(v) for k, v in _REGISTRY.items()}


def report(reset: bool = False) -> str:
    """One JSON line per phase with seconds/calls/GCUPS."""
    lines = []
    for name, v in sorted(_REGISTRY.items()):
        row = {
            "phase": name,
            "calls": v["calls"],
            "seconds": round(v["seconds"], 4),
        }
        if v["cells"]:
            row["gcups"] = round(gcups(v["cells"], v["seconds"]), 3)
        lines.append(json.dumps(row))
    if reset:
        _REGISTRY.clear()
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = None):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's where one is present) written to ``log_dir`` as a Chrome
    trace (``<pid>.<ns>.pt.trace.json``) when a directory is given; a
    no-op otherwise.  Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, "%d.%d.pt.trace.json" % (os.getpid(), time.time_ns())))
