"""Small sizes of the cells' configuration and mixes, for the CPU."""

import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name="tx1t", **kw):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(block=400, indel_margin=50, spacer=[20, 60])
    cfg.update(kw)
    return cfg


def traffic(name="b16", **kw):
    with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
        tr = json.load(f)
    tr.update(pairs_per_call=3, pool=2, trace_calls=1)
    tr.update(kw)
    return tr


def genome(size=20_000, blocks=2, **kw):
    """The genome configuration at ``size`` letters, K_min as the
    configuration sets it (size / blocks / 8)."""
    with open(os.path.join(BENCH_DIR, "configs", "genome5t.json")) as f:
        cfg = json.load(f)
    cfg.update(size=size, blocks=blocks,
               order=[(3 * k + 1) % blocks for k in range(blocks)])
    cfg["discovery"] = dict(cfg["discovery"], K_min=size // blocks // 8)
    cfg.update(kw)
    return cfg
