"""Entry ``extend_segments``: batched banded extension with transcripts.

Each call hands ``biseqt_tpu_torch.pipeline.extend_segments`` one batch
of the pool (S, T and one candidate segment per planted block) and gets
back every row with its score, start cell and MSID transcript.  Set-up
makes ``traffic["pool"]`` batches of ``traffic["pairs_per_call"]``
planted pairs from the seed (:func:`harness.generate.planted_pairs`);
calls cycle through them.  Each batch's S and T hold only its own
blocks.
"""

import sys
import time

import numpy as np
import torch

from harness import generate, rowcheck
from reference import cut as refcut


class Entry:
    def __init__(self, config, traffic, seed, device):
        from biseqt_tpu_torch import pipeline
        from biseqt_tpu_torch.sequence import Alphabet, Sequence

        self.extend = pipeline.extend_segments
        self.device = device
        sc = config["scoring"]
        A = len(config["alphabet"])
        self.subst = np.where(np.eye(A, dtype=bool), sc["match"],
                              sc["mismatch"]).astype(np.float32)
        self.go, self.ge = float(sc["go"]), float(sc["ge"])
        alphabet = Alphabet(config["alphabet"])
        g = generate.generator(seed, device)
        self.items = []
        for _ in range(int(traffic["pool"])):
            s, t, segments = generate.planted_pairs(
                g, int(traffic["pairs_per_call"]), config)
            rows = refcut.rows_of(segments, len(s), len(t), True)
            self.items.append(dict(
                s=s, t=t, S=Sequence(alphabet, s), T=Sequence(alphabet, t),
                segments=segments, rows=rows,
                cells=sum(refcut.band_cells(c) for _, _, c in rows)))

    def __len__(self):
        return len(self.items)

    def call(self, k):
        item = self.items[k % len(self.items)]
        return self.extend(item["S"], item["T"], item["segments"],
                           subst=self.subst, go_score=self.go,
                           ge_score=self.ge, with_transcripts=True,
                           device=self.device)

    def cells(self, k):
        """Band cells of call ``k``, counted from the segments handed over
        (the library's rule, frozen in :mod:`reference.cut`)."""
        return self.items[k % len(self.items)]["cells"]

    def k1_rows(self, k):
        """``(band cells, S letters, T letters)`` of each row call ``k``
        makes the DP solve."""
        item = self.items[k % len(self.items)]
        return [(refcut.band_cells(c), c[1] - c[0], c[3] - c[2])
                for _, _, c in item["rows"]]

    def reference_scores(self, dtype=torch.float32, device="cpu"):
        """The reference's score of every row of every batch of the pool,
        as one array per batch."""
        return rowcheck.reference_scores(
            [(it["s"], it["t"], it["rows"]) for it in self.items],
            self.subst, self.go, self.ge, dtype, device)

    def judge(self, done, device="cpu"):
        """Hold every row of every call in ``done`` (``[(k, rows or
        None)]``, None for a call that raised) to the reference
        (:func:`harness.rowcheck.call_gap`).  Returns ``({"ref_gap":
        (worst gap, limit)}, calls that failed)``."""
        t0 = time.perf_counter()
        ref = self.reference_scores(device=device)
        print("reference: %d rows in %.3f s" % (
            sum(len(r) for r in ref), time.perf_counter() - t0),
            file=sys.stderr)
        worst, failed, seen = 0.0, 0, {}
        for k, out in done:
            n = k % len(self.items)
            it = self.items[n]
            gap = rowcheck.call_gap(out, it["rows"], ref[n], it["s"],
                                    it["t"], self.subst, self.go, self.ge,
                                    seen, n)
            worst = max(worst, gap)
            failed += gap > 0
        return {"ref_gap": (worst, 0.0)}, failed

    def control(self, device="cpu"):
        """The control's reading: the reference in bfloat16 in the
        program's place, read on its scores (it gives no transcripts)."""
        ref = self.reference_scores(torch.float32, device)
        low = self.reference_scores(torch.bfloat16, device)
        return {"ref_gap": max(float(abs(a - b).max())
                               for a, b in zip(ref, low))}
