"""Entry ``map_reads``: long reads mapped to a fixed reference.

Each call hands ``biseqt_tpu_torch.pipeline.map_reads`` one batch of the
pool with the configuration's query settings and transcripts on:
Word-Blot over the reference's k-mer table (each read's seeds served
from it, one statistics call for the batch), then every read's best
segment extended in one extension.  Set-up makes the reference and
``traffic["pool"]`` batches of ``traffic["reads_per_call"]`` reads from
the seed (:func:`mapped_reads`) and builds the mapper once; calls cycle
through the batches.
"""

import sys
import time

import numpy as np
import torch

from harness import blotcheck, generate, rowcheck
from reference import cut as refcut, mapping as refmap

# a read's best segment "finds its locus" when its diagonal band, grown
# by this many diagonals, holds the locus (the JAX package's
# fixed-reference benchmark's tolerance); reported, not judged
RECALL_RADIUS = 200


def mapped_reads(seed, cfg, n):
    """The reference of ``cfg["size"]`` letters and ``n`` reads, each a
    locus of ``cfg["read_len"]`` letters through
    :func:`harness.generate.channel` (``cfg["sub"]``, ``cfg["go"]``,
    ``cfg["ge"]``): ``(reference codes, [read codes], [locus])``, numpy
    on the host.  The seed draws the reference's letters and the
    channel's substitutions and letters; the loci and the indels are
    drawn from ``cfg["layout_seed"]``."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    geometry = np.random.default_rng(int(cfg["layout_seed"]))
    A = len(cfg["alphabet"])
    size, L = int(cfg["size"]), int(cfg["read_len"])
    ref = rng.integers(0, A, size).astype(np.int8)
    reads, loci = [], []
    for _ in range(n):
        r0 = int(geometry.integers(0, size - L))
        reads.append(generate.channel(rng, ref[r0:r0 + L], cfg["sub"],
                                      cfg["go"], cfg["ge"], A, geometry))
        loci.append(r0)
    return ref, reads, loci


class Entry:
    def __init__(self, config, traffic, seed, device):
        from biseqt_tpu_torch.blot import WordBlotLocalRef
        from biseqt_tpu_torch.pipeline import map_reads
        from biseqt_tpu_torch.sequence import Alphabet, Sequence

        self.map, self.device, self.config = map_reads, device, config
        self.query = config["query"]
        sc = config["scoring"]
        A = len(config["alphabet"])
        self.subst = np.where(np.eye(A, dtype=bool), sc["match"],
                              sc["mismatch"]).astype(np.float32)
        self.go, self.ge = float(sc["go"]), float(sc["ge"])
        per_call = int(traffic["reads_per_call"])
        n = per_call * int(traffic["pool"])
        self.ref, self.reads, self.loci = mapped_reads(seed, config, n)
        alphabet = Alphabet(config["alphabet"])
        m = config["mapper"]
        self.mapper = WordBlotLocalRef(Sequence(alphabet, self.ref),
                                       wordlen=m["wordlen"],
                                       g_max=m["g_max"], device=device)
        self.batches = [[Sequence(alphabet, r) for r in
                         self.reads[b:b + per_call]]
                        for b in range(0, n, per_call)]
        self.per_call = per_call
        self._table, self._want, self._scores = None, {}, None

    def __len__(self):
        return len(self.batches)

    def call(self, k):
        return self.map(self.mapper, self.batches[k % len(self.batches)],
                        subst=self.subst, go_score=self.go, ge_score=self.ge,
                        with_transcripts=True, device=self.device,
                        **self.query)

    def reads_of(self, k):
        """The pool indices of call ``k``'s reads."""
        b = k % len(self.batches)
        return range(b * self.per_call, (b + 1) * self.per_call)

    def want(self, q, dtype=torch.float64):
        """The reference's segments of read ``q``, its best segment's index
        and the rows an extension of it solves (cached per read of the
        pool; ``dtype``: the statistics' precision)."""
        if self._table is None:
            t0 = time.perf_counter()
            m = self.config["mapper"]
            self._table = refmap.RefTable(self.ref, m["wordlen"],
                                          len(self.config["alphabet"]))
            print("reference table: %d keys in %.3f s" % (
                len(self._table.keys), time.perf_counter() - t0),
                file=sys.stderr)
        if dtype != torch.float64:
            return refmap.similar_segments(
                self.reads[q], self._table, self.config["mapper"]["g_max"],
                dtype=dtype, **self.query)
        if q not in self._want:
            segs = refmap.similar_segments(
                self.reads[q], self._table, self.config["mapper"]["g_max"],
                **self.query)
            b = refmap.best(segs)
            rows = [] if b is None else refcut.rows_of(
                [segs[b]], len(self.reads[q]), len(self.ref), True)
            self._want[q] = segs, b, rows
        return self._want[q]

    def cells(self, k):
        """Band cells of call ``k``: the rows of the reference's best
        segments (the library's rule, frozen in :mod:`reference.cut`)."""
        return sum(refcut.band_cells(c) for q in self.reads_of(k)
                   for _, _, c in self.want(q)[2])

    def k1_rows(self, k):
        return [(refcut.band_cells(c), c[1] - c[0], c[3] - c[2])
                for q in self.reads_of(k) for _, _, c in self.want(q)[2]]

    def reference_scores(self, dtype=torch.float32, device="cpu"):
        """The reference's score of every row of every read of the pool,
        one array a read."""
        return rowcheck.reference_scores(
            [(self.reads[q], self.ref, self.want(q)[2])
             for q in range(len(self.reads))],
            self.subst, self.go, self.ge, dtype, device)

    def recall(self, done):
        """The share of the judged calls' mapped reads whose best segment
        lies on the read's locus."""
        hit = seen = 0
        for k, out in done:
            for q, o in zip(self.reads_of(k), out or []):
                if o["best"] is None:
                    continue
                (d_lo, d_hi), _ = o["segments"][o["best"]]["segment"]
                seen += 1
                hit += (d_lo - RECALL_RADIUS <= -self.loci[q]
                        <= d_hi + RECALL_RADIUS)
        return hit / max(seen, 1)

    def judge(self, done, device="cpu"):
        """Every call's reads: segments (boxes and seed counts) and the
        best segment's index exactly (``exact_diff``), p, S0 and S1
        within ``stat_gap``'s limit, and the best segment's rows against
        the reference (:func:`harness.rowcheck.call_gap`)."""
        t0 = time.perf_counter()
        for q in range(len(self.reads)):
            self.want(q)
        t1 = time.perf_counter()
        ref = self.reference_scores(device=device)
        print("reference: %d reads' segments in %.3f s, %d rows in %.3f s;"
              " locus recall %.4f" % (
                  len(self.reads), t1 - t0, sum(len(r) for r in ref),
                  time.perf_counter() - t1, self.recall(done)),
              file=sys.stderr)
        limit = self.config["limits"]["stat_gap"]
        exact, stat, worst, failed, seen = 0, 0.0, 0.0, 0, {}
        for k, out in done:
            qs = self.reads_of(k)
            if out is None or len(out) != len(qs):
                out = [None] * len(qs)
            e, s, gap = 0, 0.0, 0.0
            for q, o in zip(qs, out):
                segs, b, rows = self.want(q)
                if o is None:
                    e, s = e + len(segs) + 1, float("inf")
                    gap = max(gap, rowcheck.call_gap(
                        None, rows, ref[q], None, None, None, 0, 0, seen, q))
                    continue
                e += blotcheck.segment_diff(o["segments"], segs)
                e += o["best"] != b
                s = max(s, blotcheck.stat_gap(o["segments"], segs))
                gap = max(gap, rowcheck.call_gap(
                    o["rows"], rows, ref[q], self.reads[q], self.ref,
                    self.subst, self.go, self.ge, seen, q))
            exact, stat, worst = max(exact, e), max(stat, s), max(worst, gap)
            failed += e > 0 or s > limit or gap > 0
        return {"exact_diff": (exact, 0), "stat_gap": (stat, limit),
                "ref_gap": (worst, 0.0)}, failed

    def control(self, device="cpu"):
        """The control's readings: the reference's statistics and DP in
        bfloat16 in the program's place (read on the segments, their
        statistics and the scores: it gives no transcripts)."""
        exact, stat = 0, 0.0
        for q in range(len(self.reads)):
            want = self.want(q)[0]
            low = self.want(q, torch.bfloat16)
            exact += blotcheck.segment_diff(low, want)
            exact += refmap.best(low) != self.want(q)[1]
            stat = max(stat, blotcheck.stat_gap(low, want))
        ref = self.reference_scores(torch.float32, device)
        low = self.reference_scores(torch.bfloat16, device)
        return {"exact_diff": exact, "stat_gap": stat,
                "ref_gap": max((float(abs(a - b).max()) for a, b in
                                zip(ref, low) if len(a)), default=0.0)}
