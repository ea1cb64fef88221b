"""Transcript throughput of ``pipeline.extend_segments``: the port of
``experiments/pipeline_tx_probe.py``.

``n`` homologous cores of ``len`` letters (10% substitutions) planted
back to back on the main diagonal of S and T, one hand-made segment a
core (``((-40, 40), (2 k len, 2 k len + 2 len))``), extended with
transcripts (``pad_radius`` 16, gap open -2, extend -1): everything a
user pays for is timed (launch grouping, padding, the DP and walk
kernels, the copies back, the C++ compaction, the scatter back), the
sequences' construction is not.  Two legs: ``device_walk`` (the walk
kernel and ``native.compact_sweep_ops_t``) and ``host_walk``
(``device_walk=False``: the plane copied back and walked by
``native.traceback_batch_ad``).  The JAX script's two legs, its
lane-packed and sublane walks, are one walk kernel here.  Both legs
must give the same transcripts, scores and start cells on the seed-99
workload (``walks_agree``); each leg reports the cells a second of
``reps`` runs on fresh seed-11 workloads and their median.

    python -m biseqt_tpu_torch.experiments.pipeline_tx_probe [--n 512]
        [--len 2000] [--reps 3]
"""

import argparse
import json
import time

import numpy as np
import torch

from .. import pipeline
from ..ops.banded_dp import resolve_device
from ..sequence import Alphabet, Sequence

__all__ = ["build_workload", "run_once", "run", "main", "LEGS"]

SUBST = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
LEGS = (("device_walk", True), ("host_walk", False))


def build_workload(n, core_len, rng):
    """``(S, T, segments)``: ``n`` homologous cores planted back to back
    on the main diagonal (the JAX probe's draws, in its order)."""
    A4 = Alphabet("ACGT")
    ss = rng.integers(0, 4, (n, core_len), dtype=np.int8)
    ts = ss.copy()
    m = rng.random((n, core_len)) < 0.1
    ts[m] = (ts[m] + rng.integers(1, 4, int(m.sum()))) % 4
    segments = []
    for k in range(n):
        a0 = 2 * k * core_len
        segments.append({"segment": ((-40, 40), (a0, a0 + 2 * core_len)),
                         "p": 0.9})
    return (Sequence(A4, ss.reshape(-1)), Sequence(A4, ts.reshape(-1)),
            segments)


def run_once(S, T, segments, device_walk, device):
    """One timed extension: ``(seconds, band cells, rows)``."""
    t0 = time.perf_counter()
    out = pipeline.extend_segments(
        S, T, segments, subst=SUBST, go_score=-2.0, ge_score=-1.0,
        with_transcripts=True, pad_radius=16, device_walk=device_walk,
        device=device)
    dt = time.perf_counter() - t0
    assert sum(len(seg["transcript"]) for seg in out) > 0
    return dt, sum(seg["band_cells"] for seg in out), out


def run(n=512, core_len=2000, reps=3, device="cuda"):
    """Both legs; one dict.  Raises if the legs' transcripts differ."""
    device = resolve_device(device)
    rng = np.random.default_rng(11)
    out = {"metric": "pipeline_transcripts", "n_segments": n,
           "core_len": core_len}
    S0, T0, seg0 = build_workload(n, core_len, np.random.default_rng(99))
    agreed = {}
    for label, device_walk in LEGS:
        # the first call also warms the leg up
        agreed[label] = [
            (seg["transcript"], seg["score"], seg["origin_start"],
             seg["mutate_start"])
            for seg in run_once(S0, T0, seg0, device_walk, device)[2]]
        rates = []
        for _ in range(reps):
            S, T, segments = build_workload(n, core_len, rng)
            dt, cells, _ = run_once(S, T, segments, device_walk, device)
            rates.append(cells / dt / 1e9)
        out[label + "_gcups_runs"] = rates
        out[label + "_gcups"] = float(np.median(rates))
    if agreed["device_walk"] != agreed["host_walk"]:
        raise RuntimeError("the device and host walks disagree")
    out["walks_agree"] = True
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--len", type=int, dest="core_len", default=2000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps(run(args.n, args.core_len, args.reps)))


if __name__ == "__main__":
    main()
