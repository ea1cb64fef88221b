"""Profiling / observability: phase timers and GCUPS counters.

The port's counterpart of :mod:`biseqt_tpu.profiling`.  ``Phase``
timers aggregate into a process-wide registry that :func:`report`
prints as JSON lines.  CUDA launches return before the card finishes,
so honest wall-clock needs a synchronisation inside the timed region:
``Phase`` takes an optional ``result`` and synchronises the devices of
the CUDA tensors in it before the timer stops.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import torch

__all__ = ["Phase", "counters", "report", "gcups", "materialize"]

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
