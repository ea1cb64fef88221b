"""BASELINE config 7p: end-to-end two-tier protein search, the port of
``experiments/protein_search.py``.

Workload: B query x ref banded local alignments of protein pairs under
BLOSUM62 (go -11, ge -1, band 100).  The two-tier path
(:func:`biseqt_tpu_torch.protein.two_tier_scores`) filters under a
reduced alphabet (Dayhoff-6 by default) and rescores the survivors under
full BLOSUM62, both tiers on the antidiagonal DP kernel
(:func:`biseqt_tpu_torch.ops.dp_ad.banded_dp_ad`).

Planted truth: 10% of pairs are homologs (25% residue substitutions);
the rest are unrelated.  Reported: filter/full/two-tier GCUPS,
effective-vs-full-only speedup, survivor fraction, homolog recall, and
exact-score agreement of the rescore tier with a full-only run.  Each
timed leg launches its batches back to back and is read by
:func:`steady_runs` from CUDA events (the host clock on the CPU).

Usage: python -m biseqt_tpu_torch.experiments.protein_search
[--quick] [--murphy10] [--murphy4]
"""

import argparse
import json
import time

import numpy as np
import torch

from ..matrices import (BLOSUM62, DAYHOFF6_GROUPS, MURPHY4_GROUPS,
                        MURPHY10_GROUPS, compression_map, reduced_matrix)
from ..ops.banded_dp import ModeFlags, on_device, resolve_device
from ..ops.dp_ad import banded_dp_ad
from ..protein import compress_codes, null_threshold, two_tier_scores

GROUPS = {"dayhoff6": DAYHOFF6_GROUPS, "murphy10": MURPHY10_GROUPS,
          "murphy4": MURPHY4_GROUPS}


def steady_runs(t0, ts, cells):
    """Completion-delta accounting shared by every timed leg.

    Returns ``(dt_steady, runs)``: the steady-state median per-run delta
    (the first delta is excluded: it absorbs the leg's fill) and the
    per-run GCUPS list (fill delta included, for transparency)."""
    dts = np.diff([t0] + list(ts))
    runs = [round(cells / d / 1e9, 2) for d in dts]
    dt = float(np.median(dts[1:])) if len(dts) > 1 else float(dts[0])
    return dt, runs


class _Stamps:
    """Timestamps in stream order: CUDA events on a card, read after a
    synchronise; the host clock on the CPU, where an operation has
    finished when it returns."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self):
        """Seconds from the first mark to each later one."""
        first, rest = self.marks[0], self.marks[1:]
        if self.cuda:
            torch.cuda.synchronize()
            return [first.elapsed_time(e) / 1e3 for e in rest]
        return [m - first for m in rest]


def mk_batch(rng, B, L, hom_frac=0.1, sub_rate=0.25):
    ss = rng.integers(0, 20, (B, L), dtype=np.int8)
    ts = rng.integers(0, 20, (B, L), dtype=np.int8)
    n_hom = int(B * hom_frac)
    hom = rng.permutation(B)[:n_hom]
    ts[hom] = ss[hom]
    m = rng.random((n_hom, L)) < sub_rate
    ts[hom] = np.where(
        m, rng.integers(0, 20, (n_hom, L), dtype=np.int8), ts[hom])
    is_hom = np.zeros(B, bool)
    is_hom[hom] = True
    return ss, ts, is_hom


def run(B=16384, L=2048, groups="dayhoff6", n_batches=4, seed=11,
        device="cuda"):
    """The experiment's JSON row: ``n_batches`` batches of ``B`` pairs of
    ``L`` residues for each timed leg."""
    device = resolve_device(device)
    BW, W = 100, 128
    group_set = GROUPS[groups]
    go, ge = -11.0, -1.0
    flags = ModeFlags(local_start=True, local_end=True)
    lens = np.full((B,), L, np.int32)
    dmin = np.full((B,), -(BW // 2), np.int32)
    w_eff = np.full((B,), BW, np.int32)
    kw = dict(W=W, go=go, ge=ge, flags=flags)
    cells = B * L * BW
    rng = np.random.default_rng(seed)
    on = lambda x, dtype=torch.int8: on_device(x, dtype, device)
    g_lens, g_dmin = on(lens, torch.int32), on(dmin, torch.int32)
    g_weff = on(w_eff, torch.int32)

    def run_pallas(a, b, mat, rows=slice(None)):
        return banded_dp_ad(a[rows], b[rows], g_lens[rows], g_lens[rows],
                            g_dmin[rows], subst=mat, w_eff=g_weff[rows],
                            device=device, **kw)

    # ---- null calibration (unrelated pairs, reduced tier) ----
    cmap = compression_map(group_set)
    red = reduced_matrix(BLOSUM62, group_set)
    ns, nt, _ = mk_batch(rng, B, L, hom_frac=0.0)
    null = run_pallas(on(compress_codes(ns, cmap)),
                      on(compress_codes(nt, cmap)), red)
    thr = null_threshold(null.score.cpu().numpy(), margin=5.0)

    out = {"config": "7p", "B": B, "L": L, "BW": BW, "groups": groups,
           "threshold": round(thr, 1)}

    # ---- timed legs over inputs already on the device; reduced codes
    # are made ahead, as a store keeps them beside the full ones.  Each
    # leg has batches of its own.
    setA = [mk_batch(rng, B, L) for _ in range(n_batches)]   # full-only
    setB = [mk_batch(rng, B, L) for _ in range(n_batches)]   # filter
    setC = [mk_batch(rng, B, L) for _ in range(n_batches)]   # two-tier
    warm = mk_batch(rng, B, L)

    dev_full = lambda s: [(on(ss), on(ts)) for ss, ts, _ in s]
    dev_red = lambda s: [(on(compress_codes(ss, cmap)),
                          on(compress_codes(ts, cmap))) for ss, ts, _ in s]
    devA, devB = dev_full(setA), dev_red(setB)
    devC_red, devC_full = dev_red(setC), dev_full(setC)

    def pipeline(pairs, mat):
        stamps = _Stamps(device)
        stamps.mark()
        for a, b in pairs:
            run_pallas(a, b, mat)
            stamps.mark()
        return steady_runs(0.0, stamps.seconds(), cells)[0]

    run_pallas(*(on(x) for x in warm[:2]), BLOSUM62)     # warm-up
    dt_full = pipeline(devA, BLOSUM62)
    out["gcups_full_only"] = round(cells / dt_full / 1e9, 2)
    dt_filt = pipeline(devB, red)
    out["gcups_filter"] = round(cells / dt_filt / 1e9, 2)

    # two-tier end to end: every filter launched, then each batch's
    # survivors rescored as its filter scores reach the host
    stamps = _Stamps(device)
    stamps.mark()
    fouts = []
    for a, b in devC_red:
        fouts.append(run_pallas(a, b, red).score)
        stamps.mark()
    tiers, routs = [], []
    for k, o in enumerate(fouts):
        sc = o.cpu().numpy()
        idx = np.flatnonzero(sc >= thr).astype(np.int32)
        tiers.append((sc, idx))
        rows = on(idx if idx.size else np.zeros(1, np.int32), torch.int64)
        routs.append(run_pallas(*devC_full[k], BLOSUM62, rows).score)
        stamps.mark()
    ts = stamps.seconds()
    resc = [o.cpu().numpy() for o in routs]
    # the stream is in order: every rescore runs behind the remaining
    # filters, so the deltas between rescores time the rescore leg alone
    # and the filter deltas are added back
    dt_filt_leg = steady_runs(0.0, ts[:n_batches], cells)[0]
    dt_resc_leg = float(np.median(np.diff(ts[n_batches:])))
    dt_tt = dt_filt_leg + dt_resc_leg
    out["gcups_two_tier"] = round(cells / dt_tt / 1e9, 2)
    out["speedup_vs_full_only"] = round(dt_full / dt_tt, 2)
    # the JAX package divides by its uniform-DNA headline on a TPU; no
    # such headline was measured on the card
    out["eff_vs_uniform_dna"] = None

    # ---- accuracy (on the two-tier leg's batches, untimed) ----
    fullC = [run_pallas(a, b, BLOSUM62).score.cpu().numpy()
             for a, b in devC_full]
    recalls, fracs, agree = [], [], True
    for (ss, ts_, is_hom), fsc, (sc, idx), rs in zip(
            setC, fullC, tiers, resc):
        surv = sc >= thr
        recalls.append(surv[is_hom].mean())
        fracs.append(surv.mean())
        agree &= np.array_equal(rs[:idx.size], fsc[idx])
    out["homolog_recall"] = round(float(np.mean(recalls)), 4)
    out["survivor_frac"] = round(float(np.mean(fracs)), 4)
    out["rescore_exact"] = bool(agree)

    # the per-call API agrees with the inline flow
    res0 = two_tier_scores(
        setC[0][0], setC[0][1], lens, lens, dmin, w_eff=w_eff,
        threshold=thr, engine="pallas", groups=group_set, device=device,
        **kw)
    out["api_matches"] = bool(
        np.array_equal(res0.survivor_idx, tiers[0][1])
        and np.array_equal(res0.full_scores[res0.survivor_idx],
                           resc[0][:tiers[0][1].size]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--murphy10", action="store_true")
    ap.add_argument("--murphy4", action="store_true")
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--L", type=int, default=2048)
    args = ap.parse_args()
    B, L = (1024, 512) if args.quick else (args.B, args.L)
    groups = ("murphy4" if args.murphy4
              else "murphy10" if args.murphy10 else "dayhoff6")
    print(json.dumps(run(B, L, groups, n_batches=2 if args.quick else 4)))


if __name__ == "__main__":
    main()
