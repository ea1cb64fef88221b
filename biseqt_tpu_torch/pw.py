"""Pairwise alignment API: ``Aligner`` / ``Alignment`` over the DP engines.

The port of :mod:`biseqt_tpu.pw` (the reference's ``biseqt/pw.py —
Aligner, Alignment`` over ``pwlib``'s ``dptable_init/solve/traceback``).
``Aligner(..., backend=..., device=...)`` solves with one of four
engines:

* ``"lax"``: the row-wavefront reference engine
  (:mod:`.ops.banded_dp`), plain PyTorch on ``device``, both modes;
* ``"native"``: the C++ host engine (:func:`.native.align`);
* ``"pallas"``: the antidiagonal DP kernel (:mod:`.ops.dp_ad`), walked
  by the C++ host walker (:func:`.native.traceback_batch_ad`); banded
  modes only;
* ``"pallas_row"``: the row DP kernel (:mod:`.ops.dp_row`), walked by
  :func:`.ops.banded_dp.traceback_path`; banded modes only.

The names of the last two are the JAX package's.  On ``device="cuda"``
(the default, which raises without a card) they launch the port's CUDA
kernels; on ``device="cpu"`` their plain PyTorch twins.  Sequences go
to the engines at their own lengths (the JAX package pads them to shape
buckets to limit jit recompiles; PyTorch does not compile per shape),
and the band width is rounded up only where a kernel needs it, with the
requested width in ``w_eff``.

Alignment modes (pwlib's ``alnmode`` / alntype enums):
    STD_MODE with GLOBAL, LOCAL, OVERLAP, START_ANCHORED, END_ANCHORED,
    START_ANCHORED_OVERLAP, END_ANCHORED_OVERLAP;
    BANDED_MODE with B_GLOBAL, B_LOCAL, B_OVERLAP (``diag_range`` = the
    inclusive diagonal band ``dmin <= i - j <= dmax``).

Gap scoring: a gap run of length g scores ``go_score + g * ge_score``
(affine; ``go_score <= 0``).
"""

from __future__ import annotations

import numpy as np

from .sequence import Sequence, EditTranscript
from .ops.banded_dp import (ModeFlags, banded_dp, full_dp, full_dp_traceback,
                            resolve_device, traceback_path)

__all__ = [
    "STD_MODE", "BANDED_MODE",
    "GLOBAL", "LOCAL", "OVERLAP",
    "START_ANCHORED", "END_ANCHORED",
    "START_ANCHORED_OVERLAP", "END_ANCHORED_OVERLAP",
    "B_GLOBAL", "B_LOCAL", "B_OVERLAP",
    "Aligner", "Alignment",
]

# alignment modes
STD_MODE = 0
BANDED_MODE = 1

# std alignment types
GLOBAL = "GLOBAL"
LOCAL = "LOCAL"
OVERLAP = "OVERLAP"
START_ANCHORED = "START_ANCHORED"
END_ANCHORED = "END_ANCHORED"
START_ANCHORED_OVERLAP = "START_ANCHORED_OVERLAP"
END_ANCHORED_OVERLAP = "END_ANCHORED_OVERLAP"

# banded alignment types
B_GLOBAL = "B_GLOBAL"
B_LOCAL = "B_LOCAL"
B_OVERLAP = "B_OVERLAP"

STD_TYPES = (
    GLOBAL, LOCAL, OVERLAP, START_ANCHORED, END_ANCHORED,
    START_ANCHORED_OVERLAP, END_ANCHORED_OVERLAP,
)
BANDED_TYPES = (B_GLOBAL, B_LOCAL, B_OVERLAP)

_FLAGS = {
    GLOBAL: ModeFlags(),
    LOCAL: ModeFlags(local_start=True, local_end=True),
    OVERLAP: ModeFlags(free_start_edges=True, free_end_edges=True),
    START_ANCHORED: ModeFlags(local_end=True),
    END_ANCHORED: ModeFlags(local_start=True),
    START_ANCHORED_OVERLAP: ModeFlags(free_end_edges=True),
    END_ANCHORED_OVERLAP: ModeFlags(free_start_edges=True),
    B_GLOBAL: ModeFlags(),
    B_LOCAL: ModeFlags(local_start=True, local_end=True),
    B_OVERLAP: ModeFlags(free_start_edges=True, free_end_edges=True),
}

BACKENDS = ("lax", "native", "pallas", "pallas_row")


def _bucket(n: int, mini: int = 32) -> int:
    """Round n up to the JAX package's band-width grid (<= 25% waste);
    with ``mini=128`` the result is a multiple of 128."""
    n = max(int(n), 1)
    if n <= mini:
        return mini
    step = max(mini, 1 << (max(n.bit_length(), 3) - 3))
    return ((n + step - 1) // step) * step


class Alignment:
    """A pairwise alignment: transcript + score + start coordinates.

    Mirrors ``biseqt/pw.py — Alignment``.  ``origin_start``/``mutate_start``
    are the 0-based positions where the aligned region begins in each
    sequence; ``transcript`` is an :class:`EditTranscript` over MSID.
    """

    def __init__(self, origin, mutate, transcript, score=None,
                 origin_start=0, mutate_start=0):
        self.origin = origin
        self.mutate = mutate
        self.transcript = EditTranscript(transcript)
        self.score = score
        self.origin_start = int(origin_start)
        self.mutate_start = int(mutate_start)
        # sanity: transcript must fit within the sequences
        assert self.origin_start + self.transcript.origin_len <= len(origin)
        assert self.mutate_start + self.transcript.mutate_len <= len(mutate)

    @property
    def origin_end(self) -> int:
        return self.origin_start + self.transcript.origin_len

    @property
    def mutate_end(self) -> int:
        return self.mutate_start + self.transcript.mutate_len

    def calculate_score(self, subst_scores, go_score, ge_score) -> float:
        """Recompute the transcript's score under given scores (oracle)."""
        s, t = self.origin, self.mutate
        i, j = self.origin_start, self.mutate_start
        score = 0.0
        prev = None
        for op in self.transcript:
            if op in "MS":
                score += subst_scores[s[i]][t[j]]
                i += 1
                j += 1
            elif op == "I":
                score += ge_score + (go_score if prev != "I" else 0.0)
                j += 1
            else:  # D
                score += ge_score + (go_score if prev != "D" else 0.0)
                i += 1
            prev = op
        return score

    def render_term(self, term_width: int = 120, margin: int = 0) -> str:
        """Three-line text rendering of the alignment (origin / ops / mutate)."""
        s, t = self.origin, self.mutate
        i, j = self.origin_start, self.mutate_start
        top, mid, bot = [], [], []
        for op in self.transcript:
            if op in "MS":
                top.append(str(s[i:i + 1]))
                bot.append(str(t[j:j + 1]))
                mid.append("|" if op == "M" else ".")
                i += 1
                j += 1
            elif op == "I":
                top.append("-")
                bot.append(str(t[j:j + 1]))
                mid.append(" ")
                j += 1
            else:
                top.append(str(s[i:i + 1]))
                bot.append("-")
                mid.append(" ")
                i += 1
        lines = []
        for off in range(0, len(top), term_width):
            lines.append("".join(top[off:off + term_width]))
            lines.append("".join(mid[off:off + term_width]))
            lines.append("".join(bot[off:off + term_width]))
            lines.append("")
        return "\n".join(lines)

    def __str__(self):
        return self.render_term()

    def __repr__(self):
        return (
            "Alignment(score=%r, origin_start=%d, mutate_start=%d, "
            "transcript=%r)" % (
                self.score, self.origin_start, self.mutate_start,
                str(self.transcript),
            )
        )


class Aligner:
    """Affine-gap pairwise aligner (context manager, API parity with
    ``biseqt/pw.py — Aligner``).

    Usage::

        with Aligner(S, T, alnmode=BANDED_MODE, alntype=B_GLOBAL,
                     diag_range=(-10, 10), go_score=-3, ge_score=-1,
                     backend="pallas_row", device="cuda") as aln:
            score = aln.solve()
            alignment = aln.traceback()

    ``solve`` returns the optimal score (None when the mode admits no
    alignment, e.g. a band that misses the corner) without direction
    bytes; ``traceback`` re-solves with them once and walks them.
    """

    def __init__(self, origin, mutate, alnmode=STD_MODE, alntype=None,
                 subst_scores=None, match_score=1.0, mismatch_score=-1.0,
                 go_score=0.0, ge_score=-1.0, diag_range=None,
                 backend="lax", device="cuda"):
        assert isinstance(origin, Sequence) and isinstance(mutate, Sequence)
        assert origin.alphabet == mutate.alphabet
        self.origin = origin
        self.mutate = mutate
        self.alnmode = alnmode
        if alntype is None:
            alntype = GLOBAL if alnmode == STD_MODE else B_GLOBAL
        if alnmode == STD_MODE:
            assert alntype in STD_TYPES, "bad std alntype %r" % (alntype,)
            assert diag_range is None, "diag_range is for BANDED_MODE"
        else:
            assert alnmode == BANDED_MODE
            assert alntype in BANDED_TYPES, "bad banded alntype %r" % (alntype,)
            assert diag_range is not None, "BANDED_MODE needs diag_range"
            dmin, dmax = diag_range
            dmin, dmax = int(dmin), int(dmax)
            assert dmin <= dmax
            # clamp to meaningful diagonals
            dmin = max(dmin, -len(mutate))
            dmax = min(dmax, len(origin))
            assert dmin <= dmax, "band excludes the whole matrix"
            self.diag_range = (dmin, dmax)
        self.alntype = alntype
        A = len(origin.alphabet)
        if subst_scores is None:
            subst_scores = (
                np.full((A, A), float(mismatch_score))
                + np.eye(A) * (float(match_score) - float(mismatch_score))
            )
        self.subst_scores = np.asarray(subst_scores, dtype=np.float32)
        assert self.subst_scores.shape == (A, A)
        assert go_score <= 0, "gap open score must be <= 0"
        self.go_score = float(go_score)
        self.ge_score = float(ge_score)
        assert backend in BACKENDS, backend
        if backend in ("pallas", "pallas_row"):
            assert alnmode == BANDED_MODE, "pallas backend is banded-only"
            assert ge_score <= 0, "pallas backend needs ge <= 0"
        self.backend = backend
        self.device = resolve_device(device)
        self._entered = False
        self._result = None

    # -- context manager (parity with the reference's alloc/free) ------------
    def __enter__(self):
        self._entered = True
        return self

    def __exit__(self, *exc):
        self._entered = False
        self._result = None
        return False

    # -- solve / traceback ----------------------------------------------------
    def solve(self):
        """The optimal score, or None if the mode admits no alignment.
        Score-only: direction bytes are made by :meth:`traceback`."""
        return self._solve(with_dirs=False)

    def _codes(self):
        """``[1, L]`` code arrays (PAD-filled to at least one column) and
        the length vectors."""
        out = []
        for seq in (self.origin, self.mutate):
            codes = np.full((1, max(len(seq), 1)), -1, np.int8)
            codes[0, :len(seq)] = seq.to_array(np.int8)
            out.append(codes)
        return (out[0], out[1], np.asarray([len(self.origin)], np.int32),
                np.asarray([len(self.mutate)], np.int32))

    def _solve(self, with_dirs: bool):
        assert self._entered, "use Aligner as a context manager"
        if self.backend == "native":
            return self._solve_native()
        flags = _FLAGS[self.alntype]
        kw = dict(subst=self.subst_scores, go=self.go_score,
                  ge=self.ge_score, flags=flags, with_dirs=with_dirs,
                  device=self.device)
        s, t, sl, tl = self._codes()
        if self.alnmode == STD_MODE:
            res = full_dp(s, t, sl, tl, **kw)
            self._dmax = 0
        else:
            dmin, dmax = self.diag_range
            W_req = dmax - dmin + 1
            self._dmax = dmax
            if self.backend == "lax":
                res = banded_dp(s, t, sl, tl, [dmin], W=W_req, **kw)
            elif self.backend == "pallas":
                from .ops.dp_ad import banded_dp_ad

                # the antidiagonal kernel needs one lane of parity slack
                Wp = _bucket(W_req + 1, mini=128)
                self._ad_dmin = dmax - Wp + 1
                res = banded_dp_ad(s, t, sl, tl, [self._ad_dmin], W=Wp,
                                   w_eff=[W_req], **kw)
            else:
                from .ops.dp_row import banded_dp_row

                args, row_kw = self._row_args(with_dirs)
                res = banded_dp_row(*args, **row_kw)
        self._result = res
        self._result_has_dirs = with_dirs
        score = float(res.score[0])
        return None if score <= -1e29 else score

    def _row_args(self, with_dirs: bool):
        """``(args, kw)`` of this pair's :func:`.ops.dp_row.banded_dp_row`
        call (banded mode): the band rounded up to the kernel's width,
        the requested width as ``w_eff``, ``A`` from the alphabet."""
        s, t, sl, tl = self._codes()
        dmin, dmax = self.diag_range
        W_req = dmax - dmin + 1
        Wp = _bucket(W_req, mini=128)
        return (s, t, sl, tl, [dmax - Wp + 1]), dict(
            W=Wp, w_eff=[W_req], A=len(self.origin.alphabet),
            subst=self.subst_scores, go=self.go_score, ge=self.ge_score,
            flags=_FLAGS[self.alntype], with_dirs=with_dirs,
            device=self.device)

    def _solve_native(self):
        """Host-side solve via the C++ engine (same conventions/bytes)."""
        from . import native

        flags = _FLAGS[self.alntype]
        if self.alnmode == STD_MODE:
            dmin, dmax = -len(self.mutate), len(self.origin)
        else:
            dmin, dmax = self.diag_range
        score, ei, ej, dirs = native.align(
            self.origin.to_array(), self.mutate.to_array(),
            self.subst_scores, self.go_score, self.ge_score,
            dmin, dmax, flags, with_dirs=True,
        )
        self._dmax = dmax
        self._native_out = (score, ei, ej, dirs)
        self._result = "native"
        return None if score <= -1e29 else score

    def traceback(self):
        """Walk the direction bytes; returns an :class:`Alignment` (None
        when the mode admits no alignment)."""
        assert self._result is not None, "call solve() first"
        flags = _FLAGS[self.alntype]
        s_arr, t_arr = self.origin.to_array(), self.mutate.to_array()
        if self.backend == "native":
            from . import native

            score, ei, ej, dirs = self._native_out
            if score <= -1e29:
                return None
            ops, si, sj = native.traceback(dirs, self._dmax, s_arr, t_arr,
                                           ei, ej, flags)
            return Alignment(self.origin, self.mutate, ops, score=score,
                             origin_start=si, mutate_start=sj)
        score = float(self._result.score[0])
        if score <= -1e29:
            return None
        if self.alnmode == STD_MODE and not self._result_has_dirs:
            # full-matrix mode: a materialized [LS, LT+1] byte plane is
            # ~100 MB at 10 kbp — walk by checkpointed re-solve
            # (O(block_rows * LT) direction memory, <= 2x compute)
            s, t, sl, tl = self._codes()
            res = self._result
            (tx, i0, j0), = full_dp_traceback(
                s, t, sl, tl, subst=self.subst_scores, go=self.go_score,
                ge=self.ge_score, flags=flags, end_i=res.end_i,
                end_j=res.end_j, device=self.device)
            return Alignment(self.origin, self.mutate, tx, score=score,
                             origin_start=i0, mutate_start=j0)
        if not self._result_has_dirs:
            # banded: re-solve once with direction bytes (cached; the
            # banded plane is O(LS * W))
            self._solve(with_dirs=True)
        res = self._result
        if self.backend == "pallas":
            # the antidiagonal plane is walked by the C++ host walker
            from . import native
            from .ops.dp_ad import parity_adjusted_dmin

            if not native.available():
                raise RuntimeError(
                    "Aligner(backend='pallas').traceback() walks the dirs "
                    "plane with the C++ tier, which did not build; "
                    "use backend='lax' or 'pallas_row'")
            dminq = parity_adjusted_dmin(np.asarray([self._ad_dmin], np.int32),
                                         np.asarray([0], np.int32))
            ops, si, sj = native.traceback_batch_ad(
                res.dirs.cpu().numpy(), dminq, s_arr[None, :], t_arr[None, :],
                np.asarray([len(self.origin)], np.int32),
                np.asarray([len(self.mutate)], np.int32),
                res.end_i[:1].cpu().numpy(), res.end_j[:1].cpu().numpy(),
                flags)
            return Alignment(self.origin, self.mutate, ops[0], score=score,
                             origin_start=int(si[0]),
                             mutate_start=int(sj[0]))
        tx, i0, j0 = traceback_path(
            res.dirs[0].cpu().numpy(), s_arr, t_arr, int(res.end_i[0]),
            int(res.end_j[0]), banded=self.alnmode == BANDED_MODE,
            dmax=self._dmax, flags=flags)
        return Alignment(self.origin, self.mutate, tx, score=score,
                         origin_start=i0, mutate_start=j0)
