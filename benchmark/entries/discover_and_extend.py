"""Entry ``discover_and_extend``: sequences in, transcribed alignments out.

Each call hands ``biseqt_tpu_torch.pipeline.discover_and_extend`` the
seeded genome pair with the configuration's discovery settings and
transcripts on: Word-Blot discovery (the seed join and statistics on the
device), the window split, K1, the walk and the compaction.  Set-up
makes the pair from the seed (:func:`harness.generate.rearranged_pair`);
nothing is carried from call to call.
"""

import sys
import time

import numpy as np
import torch

from harness import blotcheck, generate, rowcheck
from reference import blot as refblot, cut as refcut


class Entry:
    def __init__(self, config, traffic, seed, device):
        from biseqt_tpu_torch import pipeline
        from biseqt_tpu_torch.sequence import Alphabet, Sequence

        self.run, self.device = pipeline.discover_and_extend, device
        self.config, self.disc = config, config["discovery"]
        sc = config["scoring"]
        A = len(config["alphabet"])
        self.subst = np.where(np.eye(A, dtype=bool), sc["match"],
                              sc["mismatch"]).astype(np.float32)
        self.go, self.ge = float(sc["go"]), float(sc["ge"])
        self.s, self.t, _ = generate.rearranged_pair(seed, config)
        alphabet = Alphabet(config["alphabet"])
        self.S, self.T = Sequence(alphabet, self.s), Sequence(alphabet,
                                                              self.t)
        self._disc = None

    def __len__(self):
        return 1

    def call(self, k):
        return self.run(self.S, self.T, subst=self.subst, go_score=self.go,
                        ge_score=self.ge, with_transcripts=True,
                        device=self.device, **self.disc)

    def discovery(self, dtype=torch.float64):
        """The reference's segments and the rows an extension of them
        solves (worked out once, after the window)."""
        if self._disc is None or dtype != torch.float64:
            t0 = time.perf_counter()
            d = self.disc
            segs = refblot.similar_segments(
                self.s, self.t, d["wordlen"], len(self.config["alphabet"]),
                d["g_max"], d["K_min"], d["p_min"], dtype=dtype)
            print("reference discovery: %d segments in %.3f s" % (
                len(segs), time.perf_counter() - t0), file=sys.stderr)
            if dtype != torch.float64:
                return segs, None
            self._disc = segs, refcut.rows_of(segs, len(self.s),
                                              len(self.t), True)
        return self._disc

    def cells(self, k):
        return sum(refcut.band_cells(c) for _, _, c in self.discovery()[1])

    def k1_rows(self, k):
        return [(refcut.band_cells(c), c[1] - c[0], c[3] - c[2])
                for _, _, c in self.discovery()[1]]

    def judge(self, done, device="cpu"):
        """Every call's rows: the discovered segments behind them (seed
        counts exactly and p within ``p_gap``'s limit; the extension
        overwrites S0 and S1 with the DP's score; a box that differs
        gives other windows, which ``ref_gap`` reads as missing rows)
        and each row's score and transcript against the reference
        (:func:`harness.rowcheck.call_gap`)."""
        want, rows = self.discovery()
        t0 = time.perf_counter()
        ref = rowcheck.reference_scores([(self.s, self.t, rows)],
                                        self.subst, self.go, self.ge,
                                        torch.float32, device)[0]
        print("reference: %d rows in %.3f s" % (
            len(rows), time.perf_counter() - t0), file=sys.stderr)
        limit = self.config["limits"]["p_gap"]
        exact, stat, worst, failed, seen = 0, 0.0, 0.0, 0, {}
        for k, out in done:
            e, s = len(want) + 1, float("inf")
            if out is not None:
                # the discovered segment behind each row
                got = {}
                for r in out:
                    got.setdefault(r["source_index"], r)
                e = sum(n not in got or int(got[n]["num_seeds"])
                        != int(w["num_seeds"]) for n, w in enumerate(want))
                e += len(set(got) - set(range(len(want))))
                s = blotcheck.stat_gap([got[n] for n in range(len(want))
                                        if n in got],
                                       [w for n, w in enumerate(want)
                                        if n in got], names=("p",))
            gap = rowcheck.call_gap(out, rows, ref, self.s, self.t,
                                    self.subst, self.go, self.ge, seen, 0)
            exact, stat, worst = max(exact, e), max(stat, s), max(worst,
                                                                   gap)
            failed += e > 0 or s > limit or gap > 0
        return {"exact_diff": (exact, 0), "p_gap": (stat, limit),
                "ref_gap": (worst, 0.0)}, failed

    def control(self, device="cpu"):
        """The control's readings: the reference's statistics and DP in
        bfloat16 in the program's place (read on p and the scores: it
        gives no transcripts)."""
        want, rows = self.discovery()
        low, _ = self.discovery(torch.bfloat16)
        groups = [(self.s, self.t, rows)]
        ref = rowcheck.reference_scores(groups, self.subst, self.go,
                                        self.ge, torch.float32, device)[0]
        ref_low = rowcheck.reference_scores(groups, self.subst, self.go,
                                            self.ge, torch.bfloat16,
                                            device)[0]
        return {"p_gap": blotcheck.stat_gap(low, want, names=("p",)),
                "exact_diff": blotcheck.segment_diff(low, want),
                "ref_gap": float(abs(ref - ref_low).max())}
