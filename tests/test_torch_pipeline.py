"""The port's extend_segments (biseqt_tpu_torch.pipeline) against the JAX
package's, on the same sequences and the same Word-Blot segments.

Reruns the geometry of tests/test_pipeline.py: the fused DP + device
walk route in interpret mode (both the sublane and the lane-packed
walk), score-only extension, the a-window split contract, and the
up-front error when the C++ tier is missing.  Tolerance is exact:
scores, transcripts, start cells and source indices equal.
"""

import pytest

import biseqt_tpu.pipeline as ref_pipeline
from biseqt_tpu.blot import WordBlot
from biseqt_tpu.pw import Alignment
from biseqt_tpu.sequence import Alphabet
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import native, pipeline
from biseqt_tpu_torch.sequence import from_reference
from test_torch_cuda import UNIT

A4 = Alphabet("ACGT")


def _two_cores(rng):
    """The tiny two-homology geometry of test_pipeline.py:170."""
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.03, ge_prob=0.1,
                        rng=rng)
    cores = [rand_seq(A4, 100, rng=rng) for _ in range(2)]
    sp = lambda n: rand_seq(A4, n, rng=rng)
    S = sp(40) + cores[0] + sp(60) + cores[1]
    T = sp(30) + M.mutate(cores[0])[0] + sp(120) + M.mutate(cores[1])[0]
    segments = list(WordBlot(S, T, wordlen=8, g_max=0.2)
                    .similar_segments(K_min=60, p_min=0.6))
    assert len(segments) >= 2
    return S, T, segments


def _rescores(S, T, out):
    for seg in out:
        aln = Alignment(S, T, seg["transcript"],
                        origin_start=seg["origin_start"],
                        mutate_start=seg["mutate_start"])
        assert aln.calculate_score(UNIT, -3.0, -1.0) == seg["score"], seg


@pytest.mark.parametrize("walk_route", ["sublane", "lane_packed"])
def test_extend_segments_matches_pallas_pipeline(rng, monkeypatch,
                                                 walk_route):
    S, T, segments = _two_cores(rng)
    monkeypatch.setattr(ref_pipeline, "_LANE_WALK_MIN_B2",
                        1 if walk_route == "lane_packed" else 10 ** 9)
    kw = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0,
              with_transcripts=True, _r_chunk=16)
    want = ref_pipeline.extend_segments(
        S, T, segments, use_pallas=True, _interpret=True, _walk_r_rows=8,
        **kw)
    got = pipeline.extend_segments(from_reference(S), from_reference(T),
                                   segments, device="cpu", **kw)
    assert got == want
    _rescores(S, T, got)
    assert all(len(seg["transcript"]) > 60 for seg in got)


def test_extend_segments_score_only_matches(rng):
    S, T, segments = _two_cores(rng)
    kw = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0, _r_chunk=16)
    want = ref_pipeline.extend_segments(S, T, segments, use_pallas=True,
                                        _interpret=True, **kw)
    got = pipeline.extend_segments(S, T, segments, device="cpu", **kw)
    assert got == want
    assert all("transcript" not in seg for seg in got)


def test_extend_segments_window_split_contract(rng):
    """A segment longer than the dirs budget splits into overlapping
    a-windows exactly as the JAX package splits it: the same windows,
    source indices and scores, and every window's transcript rescores
    to its score."""
    M = MutationProcess(A4, subst_probs=0.06, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    S = rand_seq(A4, 3000, rng=rng)
    T, _ = M.mutate(S)
    segments = list(WordBlot(S, T, wordlen=8, g_max=0.15)
                    .similar_segments(K_min=600, p_min=0.6))
    assert segments
    kw = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0,
              with_transcripts=True, _dirs_budget=1)
    want = ref_pipeline.extend_segments(S, T, segments, use_pallas=False,
                                        **kw)
    got = pipeline.extend_segments(S, T, segments, device="cpu", **kw)
    assert len(got) > len(segments)
    strip = lambda out: [(s["segment"], s["source_index"], s["score"])
                         for s in out]
    assert strip(got) == strip(want)
    _rescores(S, T, got)
    assert sum(len(seg["transcript"]) for seg in got) > 2500


def test_extend_segments_transcripts_native_unavailable(rng, monkeypatch):
    """Without the C++ tier, transcript mode fails before any launch."""
    monkeypatch.setattr(native, "available", lambda: False)
    S = from_reference(rand_seq(A4, 100, rng=rng))
    seg = {"segment": ((-10, 10), (0, 200))}
    with pytest.raises(RuntimeError, match="native C\\+\\+ tier"):
        pipeline.extend_segments(S, S, [seg], with_transcripts=True,
                                 device="cpu")
    # score-only mode does not need it
    assert pipeline.extend_segments(S, S, [seg], device="cpu")[0]["score"] > 0


def test_extend_segments_band_above_2048_matches():
    """A segment whose padded band buckets to W 3072, past the 2048 lanes
    the port's K1 once took: scores, transcript and start cells equal
    the JAX package's (its default engine), and the score is 13.0."""
    import numpy as np

    rng = np.random.default_rng(0)
    S, T = rand_seq(A4, 1200, rng=rng), rand_seq(A4, 1200, rng=rng)
    segments = [{"segment": ((-1100, 1100), (1200, 1300))}]
    cut = pipeline.cut_segment(segments[0], len(S), len(T))
    assert pipeline.plan_launches([cut], True)[0][3] == 3072
    kw = dict(go_score=-3.0, ge_score=-1.0, with_transcripts=True)
    want = ref_pipeline.extend_segments(S, T, segments, **kw)
    got = pipeline.extend_segments(from_reference(S), from_reference(T),
                                   segments, device="cpu", **kw)
    assert got == want
    assert got[0]["score"] == 13.0 and got[0]["transcript"]
    _rescores(S, T, got)
