"""Entry ``wordblot``: Word-Blot discovery without alignment.

Each call builds ``biseqt_tpu_torch.blot.WordBlot`` over the seeded
genome pair (the seed join on the device) and asks it for its similar
segments: the dot-plot and homology-map use.  Set-up makes the pair
from the seed (:func:`harness.generate.rearranged_pair`); nothing is
carried from call to call.
"""

import sys
import time

import numpy as np
import torch

from harness import blotcheck, generate
from reference import blot as refblot


class Entry:
    def __init__(self, config, traffic, seed, device):
        from biseqt_tpu_torch.blot import WordBlot
        from biseqt_tpu_torch.sequence import Alphabet, Sequence

        self.WordBlot, self.device = WordBlot, device
        self.config, self.disc = config, config["discovery"]
        self.s, self.t, _ = generate.rearranged_pair(seed, config)
        alphabet = Alphabet(config["alphabet"])
        self.S, self.T = Sequence(alphabet, self.s), Sequence(alphabet,
                                                              self.t)
        # the calls whose seeds are judged: the window's first, one drawn
        # from the seed among its next 16, and the last
        self.keep = {1, 2 + int(np.random.default_rng(
            int(seed) % (1 << 64)).integers(0, 16))}
        self.kept, self.last = {}, None
        self._ref = None

    def __len__(self):
        return 1

    def call(self, k):
        wb = self.WordBlot(self.S, self.T, wordlen=self.disc["wordlen"],
                           g_max=self.disc["g_max"], device=self.device)
        segs = list(wb.similar_segments(K_min=self.disc["K_min"],
                                        p_min=self.disc["p_min"]))
        self.last = (k, wb.seed_index.seed_arrays())
        if k in self.keep:
            self.kept[k] = self.last[1]
        return segs

    def cells(self, k):
        return 0

    def k1_rows(self, k):
        return []

    def reference(self, dtype=torch.float64, seeds=None):
        """The reference's seeds and segments (``dtype``: the precision of
        the statistics)."""
        t0 = time.perf_counter()
        d = self.disc
        A = len(self.config["alphabet"])
        if seeds is None:
            seeds = refblot.seeds(self.s, self.t, d["wordlen"], A)
        segs = refblot.similar_segments(
            self.s, self.t, d["wordlen"], A, d["g_max"], d["K_min"],
            d["p_min"], seed_arrays=seeds, dtype=dtype)
        print("reference: %d seeds, %d segments in %.3f s" % (
            len(seeds[0]), len(segs), time.perf_counter() - t0),
            file=sys.stderr)
        return seeds, segs

    def judge(self, done, device="cpu"):
        """Every call's segments (boxes and seed counts exactly; p, S0 and
        S1 within ``stat_gap``'s limit) and the seeds of the sampled
        calls against the reference."""
        seeds, want = self.reference()
        limit = self.config["limits"]["stat_gap"]
        exact, stat, failed = 0, 0.0, 0
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        for k, out in done:
            if out is None:
                e, s = len(want) + 1, float("inf")
            else:
                e = blotcheck.segment_diff(out, want)
                s = blotcheck.stat_gap(out, want)
            if k in kept:
                e += blotcheck.seeds_diff(kept[k], seeds)
            exact, stat = max(exact, e), max(stat, s)
            failed += e > 0 or s > limit
        return {"exact_diff": (exact, 0), "stat_gap": (stat, limit)}, failed

    def control(self, device="cpu"):
        """The control's readings: the reference's statistics in
        bfloat16 in the program's place."""
        seeds, want = self.reference()
        _, low = self.reference(torch.bfloat16, seeds)
        return {"stat_gap": blotcheck.stat_gap(low, want),
                "exact_diff": blotcheck.segment_diff(low, want)}
