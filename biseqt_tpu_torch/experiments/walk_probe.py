"""The on-device traceback walk, checked and timed: the port of
``experiments/walk_probe.py``.

Correctness: a small ragged batch (64 pairs of up to 1500 letters, 12%
substitutions, W 128, ``w_eff`` 120) through the DP kernel with
directions (:func:`..ops.dp_ad.banded_dp_ad`), walked both ways: the
walk kernel (:func:`..ops.walk.traceback_walk`) and the C++ replay
(``native.compact_sweep_ops_t``) must give the C++ host walker's
(``native.traceback_batch_ad``) transcripts and start cells, pair for
pair.

Throughput: 1024 pairs of 10 kbp (in 10240-letter rows) at band 100,
W 128: the DP kernel with directions and the walk, then the trace and
cursors copied to the host (fresh inputs each run, copied to the card
before the clock starts; the median of the runs), and the C++
compaction of the last run's traces.  Reports cells a second over the
two and the bytes copied back against the direction plane's.

    python -m biseqt_tpu_torch.experiments.walk_probe
"""

import argparse
import json
import time

import numpy as np
import torch

from .. import native
from ..ops.banded_dp import ModeFlags, on_device, resolve_device
from ..ops.dp_ad import banded_dp_ad, parity_adjusted_dmin
from ..ops.walk import traceback_walk
from ..profiling import materialize

__all__ = ["correctness", "throughput", "run", "main", "FLAGS", "SUBST"]

FLAGS = ModeFlags(local_start=True, local_end=True)
SUBST = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
KW = dict(W=128, subst=SUBST, go=-2.0, ge=-1.0, flags=FLAGS)


def correctness_inputs(rng, B=64, L=1500):
    """The JAX probe's ragged batch, drawn from ``rng`` in its order:
    ``(ss, ts, s_lens, t_lens, dmin, w_eff)``."""
    ss = rng.integers(0, 4, (B, L)).astype(np.int8)
    ts = ss.copy()
    m = rng.random((B, L)) < 0.12
    ts[m] = (ts[m] + 1 + rng.integers(0, 3, m.sum())) % 4
    s_lens = rng.integers(L - 200, L + 1, B).astype(np.int32)
    t_lens = rng.integers(L - 200, L + 1, B).astype(np.int32)
    dmin = rng.integers(-80, -20, B).astype(np.int32)
    w_eff = np.full(B, 120, np.int32)
    return ss, ts, s_lens, t_lens, dmin, w_eff


def correctness(rng, B=64, L=1500, device="cuda"):
    """The walk kernel and the C++ replay against the C++ host walker on
    :func:`correctness_inputs`.  Returns ``(row, transcripts)``:
    ``{"phase", "pairs", "mismatches"}`` and the walk's ``(ops, start_i,
    start_j)``."""
    device = resolve_device(device)
    ss, ts, s_lens, t_lens, dmin, w_eff = correctness_inputs(rng, B, L)
    res = banded_dp_ad(ss, ts, s_lens, t_lens, dmin, w_eff=w_eff,
                       with_dirs=True, device=device, **KW)
    dminq = parity_adjusted_dmin(dmin, np.arange(B, dtype=np.int32) % 2)
    end_i = res.end_i.cpu().numpy()
    end_j = res.end_j.cpu().numpy()
    ref = native.traceback_batch_ad(res.dirs.cpu().numpy(), dminq, ss, ts,
                                    s_lens, t_lens, end_i, end_j, FLAGS)
    trace, fi, fj = traceback_walk(res.dirs, dminq, res.end_i, res.end_j,
                                   W=KW["W"], device=device)
    got = native.compact_sweep_ops_t(trace.cpu().numpy(), fi.cpu().numpy(),
                                     fj.cpu().numpy(), ss, ts, s_lens,
                                     t_lens, FLAGS)
    bad = sum(1 for b in range(B) if got[0][b] != ref[0][b]
              or got[1][b] != ref[1][b] or got[2][b] != ref[2][b])
    return {"phase": "correctness", "pairs": B, "mismatches": bad}, got


def throughput(B=1024, L=10240, band=100, runs=3, device="cuda"):
    """DP with directions and the walk, timed to the host copy of the
    trace (median of ``runs`` fresh batches), then the C++ compaction of
    the last batch's traces."""
    device = resolve_device(device)
    n = L - 240
    w_eff = torch.full((B,), band, dtype=torch.int32, device=device)
    dmin = np.full((B,), -(band // 2), np.int32)
    dminq = on_device(parity_adjusted_dmin(
        dmin, np.arange(B, dtype=np.int32) % 2), torch.int32, device)
    lens = np.full((B,), n, np.int32)

    def inputs(seed):
        rr = np.random.default_rng(seed * 9_000_013 + 4242)
        return [on_device(x, dtype, device) for x, dtype in (
            (rr.integers(0, 4, (B, L), dtype=np.int8), torch.int8),
            (rr.integers(0, 4, (B, L), dtype=np.int8), torch.int8),
            (lens, torch.int32), (lens, torch.int32), (dmin, torch.int32))]

    def launch(args):
        res = banded_dp_ad(*args, w_eff=w_eff, with_dirs=True,
                           device=device, **KW)
        trace, fi, fj = traceback_walk(res.dirs, dminq, res.end_i,
                                       res.end_j, W=KW["W"], device=device)
        return res, trace.cpu().numpy(), fi.cpu().numpy(), fj.cpu().numpy()

    launch(inputs(0))                       # warm-up
    seconds = []
    for k in range(runs):
        args = materialize(inputs(k + 1))
        t0 = time.perf_counter()
        res, trace, fi, fj = launch(args)
        seconds.append(time.perf_counter() - t0)
    dt_dev = float(np.median(seconds))
    ss, ts = args[0].cpu().numpy(), args[1].cpu().numpy()
    t0 = time.perf_counter()
    ops, _, _ = native.compact_sweep_ops_t(trace, fi, fj, ss, ts, lens,
                                           lens, FLAGS)
    dt_compact = time.perf_counter() - t0
    assert sum(len(o) for o in ops) > 0
    return {
        "phase": "throughput",
        "gcups_transcripts_device_walk":
            B * n * band / (dt_dev + dt_compact) / 1e9,
        "s_per_batch_device": dt_dev,
        "s_per_batch_device_runs": seconds,
        "compact_s": dt_compact,
        "trace_d2h_mb": trace.nbytes / 1e6,
        "dirs_plane_mb": res.dirs.numel() / 1e6,
    }


def run(B=64, L=1500, tB=1024, tL=10240, band=100, runs=3, seed=0,
        device="cuda"):
    """Both phases; one dict (``mismatches``, the throughput keys and the
    device).  Raises if any transcript differs."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    row, _ = correctness(rng, B, L, device)
    if row["mismatches"]:
        raise RuntimeError("walk probe: %d transcripts differ from the host"
                           " walker's" % row["mismatches"])
    out = {"metric": "walk_probe", "pairs": row["pairs"],
           "mismatches": row["mismatches"]}
    out.update(throughput(tB, tL, band, runs, device))
    out.pop("phase")
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    return out


def main():
    argparse.ArgumentParser(description=__doc__).parse_args()
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
