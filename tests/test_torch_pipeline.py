"""The port's extend_segments and discover_and_extend
(biseqt_tpu_torch.pipeline) against the JAX package's, on the same
sequences and the same Word-Blot segments.

Reruns the geometry of tests/test_pipeline.py: the fused DP + device
walk route in interpret mode (both the sublane and the lane-packed
walk), the host walk route (``device_walk=False``), score-only
extension, the a-window split contract, and the up-front error when the
C++ tier is missing; and holds the port's keywords to the JAX
package's.  Tolerance is exact:
scores, transcripts, start cells and source indices equal.
"""

import numpy as np
import pytest

import biseqt_tpu.pipeline as ref_pipeline
from biseqt_tpu.blot import WordBlot
from biseqt_tpu.pw import Alignment
from biseqt_tpu.sequence import Alphabet, Sequence
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import blot as port_blot
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


def test_extend_segments_host_walk_matches(rng):
    """``device_walk=False``: the plane walked on the host by the C++
    tier.  Transcripts, start cells and scores equal the device walk's
    and the JAX package's own ``device_walk=False`` route (its Pallas
    kernel in interpret mode, its plane walked by the same C++ walk);
    a segment over unrelated sequence walks the same on both routes."""
    S, T, segments = _two_cores(rng)
    segments = segments + [{"segment": ((-50, 50), (0, 40))}]
    kw = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0,
              with_transcripts=True, _r_chunk=16)
    want = ref_pipeline.extend_segments(
        S, T, segments, use_pallas=True, _interpret=True, device_walk=False,
        **kw)
    pS, pT = from_reference(S), from_reference(T)
    on_host = pipeline.extend_segments(pS, pT, segments, device="cpu",
                                       use_pallas=None, device_walk=False,
                                       **kw)
    on_device = pipeline.extend_segments(pS, pT, segments, device="cpu",
                                         **kw)
    assert on_host == on_device == want
    _rescores(S, T, on_host)


def test_extend_segments_takes_the_jax_keywords():
    """Every keyword of the JAX package's ``extend_segments`` but its TPU
    knobs is a keyword of the port's, with the same default."""
    import inspect

    tpu_only = {"_interpret", "_walk_r_rows"}
    ref_params = inspect.signature(ref_pipeline.extend_segments).parameters
    params = inspect.signature(pipeline.extend_segments).parameters
    for name, p in ref_params.items():
        if name in tpu_only:
            assert name not in params
            continue
        assert name in params, name
        assert params[name].default == p.default, name


@pytest.mark.parametrize("use_pallas", [None, False, True])
def test_extend_segments_use_pallas_names_the_device(rng, use_pallas):
    """``use_pallas=True`` asks for the kernels: on the CPU it raises
    before any work.  ``None`` runs the plain twins there and ``False``
    the row route."""
    S = from_reference(rand_seq(A4, 100, rng=rng))
    seg = [{"segment": ((-10, 10), (0, 200))}]
    if use_pallas:
        with pytest.raises(ValueError, match="use_pallas=True contradicts"):
            pipeline.extend_segments(S, S, seg, use_pallas=True,
                                     device="cpu")
    else:
        got = pipeline.extend_segments(S, S, seg, use_pallas=use_pallas,
                                       device="cpu")
        assert got[0]["score"] == 100.0


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


def _smoke_cuts(n):
    """``n`` cuts of the smoke's shape: 11 kbp cutouts (LS = LT = 12288
    after bucketing), band 133 (W 256)."""
    return [(0, 11_024, 0, 11_020, -66 + k % 3, 66 + k % 3)
            for k in range(n)]


@pytest.mark.parametrize("budget,with_transcripts,sizes", [
    (None, True, [2048]),           # 8 GiB: 5272 pairs, floored to 4096
    (3 << 30, True, [1536, 512]),   # 1975 pairs, floored to 1536
    (1 << 30, True, [512] * 4),     # 658 pairs, floored to 512
    (1, True, [2] * 1024),          # at least one plane row a launch
    (1 << 30, False, [2048]),       # score-only: no plane
])
def test_plan_launches_fills_the_budget(monkeypatch, budget,
                                        with_transcripts, sizes):
    """The smoke's 2048-pair group goes in as few launches as the memory
    budget allows (one by default), each launch's padded batch within
    it: a pair with its dirs plane takes 1630720 bytes at this shape."""
    if budget is not None:
        monkeypatch.setattr(pipeline, "LAUNCH_BYTES", budget)
    launches = pipeline.plan_launches(_smoke_cuts(2048), with_transcripts)
    assert [len(idxs) for idxs, *_ in launches] == sizes
    assert {launch[1:] for launch in launches} == {(12288, 12288, 256)}
    per_pair = 1630720 if with_transcripts else 25088
    mini = pipeline._batch_mini(with_transcripts)
    assert all(pipeline._bucket(n, mini) * per_pair <= pipeline.LAUNCH_BYTES
               for n in sizes if n > mini)
    assert sorted(i for idxs, *_ in launches for i in idxs) == list(
        range(2048))


def _planted_blocks(rng):
    """Five planted homologous blocks of 200 bp and one segment each."""
    s_parts, t_parts, segments = [], [], []
    s_pos = t_pos = 0
    for k in range(5):         # five planted homologous blocks of 200 bp
        core = rng.integers(0, 4, 200)
        mut = core.copy()
        hit = rng.random(200) < 0.1
        mut[hit] = (mut[hit] + 1 + rng.integers(0, 3, hit.sum())) % 4
        gap_s, gap_t = 60 + 20 * k, 90 - 10 * k
        s_parts += [rng.integers(0, 4, gap_s), core]
        t_parts += [rng.integers(0, 4, gap_t), mut]
        i0, j0 = s_pos + gap_s, t_pos + gap_t
        segments.append({"segment": ((i0 - j0 - 8, i0 - j0 + 8),
                                     (i0 + j0, i0 + j0 + 400))})
        s_pos, t_pos = i0 + 200, j0 + 200
    return (Sequence(A4, np.concatenate(s_parts)),
            Sequence(A4, np.concatenate(t_parts)), segments)


def test_extend_segments_split_into_launches_changes_nothing(
        rng, monkeypatch):
    """Scores, transcripts and start cells do not depend on how the
    segments are split into launches: a memory budget small enough to
    put two pairs in each launch against the default, one launch."""
    S2, T2, segments = _planted_blocks(rng)
    calls = []
    real = pipeline.banded_dp_ad
    monkeypatch.setattr(pipeline, "banded_dp_ad",
                        lambda *a, **k: calls.append(len(a[0])) or real(
                            *a, **k))
    kw = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0,
              with_transcripts=True, _r_chunk=16, device="cpu")
    port = (from_reference(S2), from_reference(T2), segments)
    want = pipeline.extend_segments(*port, **kw)
    n_default = len(calls)
    monkeypatch.setattr(pipeline, "LAUNCH_BYTES", 1)
    got = pipeline.extend_segments(*port, **kw)
    assert len(calls) - n_default > n_default     # more, smaller launches
    assert got == want
    _rescores(S2, T2, got)
    assert all(seg["score"] > 100 for seg in got)


# the in-flight queue: five planted blocks, each split into a-windows
# (pad_a 16 and the smallest plane budget: windows of 128 antidiagonals),
# two pairs a launch
QUEUE_KW = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0, pad_a=16,
                _dirs_budget=1, _r_chunk=16)
ROUTES = {"device_walk": dict(with_transcripts=True),
          "host_walk": dict(with_transcripts=True, device_walk=False),
          "score_only": dict(with_transcripts=False)}


@pytest.fixture(scope="module")
def queue_case():
    """The sequences, each route's segments and the JAX package's output
    of each route (its host route, ``use_pallas=False``, for both
    transcript routes).  Score-only extension splits no windows and puts
    at least 8 pairs in a launch, so its segments are the transcript
    routes' windows."""
    S, T, segments = _planted_blocks(np.random.default_rng(17))
    windows = pipeline.extension_plan(segments, len(S), len(T), True,
                                      pad_a=QUEUE_KW["pad_a"],
                                      dirs_budget=1)[0]
    inputs, want = {}, {}
    for route, kw in ROUTES.items():
        inputs[route] = windows if route == "score_only" else segments
        kw = dict(QUEUE_KW, with_transcripts=kw["with_transcripts"])
        want[route] = ref_pipeline.extend_segments(
            S, T, inputs[route], use_pallas=False, **kw)
    return S, T, inputs, want


def _queued(monkeypatch, budget):
    """The plan's launches two pairs each, ``PIPELINE_BYTES`` set to
    ``budget`` (a number, or "one" / "all": the largest launch's bytes /
    every launch's), and the order of dispatches (D) and finishes (F)
    recorded."""
    monkeypatch.setattr(pipeline, "LAUNCH_BYTES", 1)
    order = []
    dispatch, finish = pipeline._dispatch, pipeline._finish
    monkeypatch.setattr(pipeline, "_dispatch", lambda *a: order.append("D")
                        or dispatch(*a))
    monkeypatch.setattr(pipeline, "_finish", lambda *a: order.append("F")
                        or finish(*a))

    def run(S, T, segments, **kw):
        kw = dict(QUEUE_KW, **kw)
        _, _, _, launches = pipeline.extension_plan(
            segments, len(S), len(T), kw["with_transcripts"],
            pad_a=kw["pad_a"], dirs_budget=kw["_dirs_budget"])
        sizes = [pipeline.launch_bytes(len(idxs), LS, LT, W,
                                       kw["with_transcripts"],
                                       kw["_r_chunk"])
                 for idxs, LS, LT, W in launches]
        monkeypatch.setattr(pipeline, "PIPELINE_BYTES", {
            "one": max(sizes), "all": sum(sizes)}.get(budget, budget))
        out = pipeline.extend_segments(S, T, segments, device="cpu", **kw)
        return out, launches

    return run, order


@pytest.mark.parametrize("budget", [0, "one", "all"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_extend_segments_in_flight_budget_changes_nothing(
        queue_case, monkeypatch, route, budget):
    """Budgets of 0 (the serial order), one launch and every launch in
    flight give the JAX package's output, byte for byte, on a plan of
    window-split segments over many launches; 0 alternates dispatch and
    finish, every launch in flight dispatches all first."""
    S, T, inputs, want = queue_case
    run, order = _queued(monkeypatch, budget)
    got, launches = run(from_reference(S), from_reference(T), inputs[route],
                        **ROUTES[route])
    assert got == want[route]
    assert len(launches) >= 3 and len(got) >= 20
    n = len(launches)
    if budget == 0:
        assert order == ["D", "F"] * n
    elif budget == "all":
        assert order == ["D"] * n + ["F"] * n
    assert sorted(order) == ["D"] * n + ["F"] * n
    if route != "score_only":
        _rescores(S, T, got)


def test_in_flight_launch_with_a_bad_walk_raises_first(queue_case,
                                                       monkeypatch):
    """Every launch in flight, the second launch's walk corrupted (one
    diagonal op turned into an insertion): its finish raises, and no
    later launch's traces were compacted."""
    import torch

    S, T, inputs, _ = queue_case
    run, order = _queued(monkeypatch, "all")
    walks, compacted = [], []
    walk = pipeline.traceback_walk

    def corrupt(*args, **kwargs):
        trace, fi, fj = walk(*args, **kwargs)
        walks.append(1)
        if len(walks) == 2:
            trace = trace.clone()
            row = int(torch.nonzero(trace[0, :, 0] & 3 == 1)[0, 0])
            trace[0, row, 0] += 1
        return trace, fi, fj

    compact = native.compact_sweep_ops_t
    monkeypatch.setattr(pipeline, "traceback_walk", corrupt)
    monkeypatch.setattr(native, "compact_sweep_ops_t",
                        lambda *a, **k: compacted.append(1)
                        or compact(*a, **k))
    with pytest.raises(RuntimeError, match="does not lead from the end"):
        run(from_reference(S), from_reference(T), inputs["device_walk"],
            with_transcripts=True)
    n = order.count("D")
    assert n >= 6 and len(walks) == n
    assert order == ["D"] * n + ["F", "F"]
    assert compacted == [1]


def test_launch_bytes_counts_codes_and_plane():
    """Codes of the padded batch, and with transcripts the dirs plane
    ``[Apad // 2, B2, W]`` of the bucketed batch."""
    assert pipeline.launch_bytes(3, 1024, 768, 256, False) == 8 * 1792
    n_pad, apad = 4, 1920           # _bucket(3, 2); 1794 up to 128
    assert pipeline.launch_bytes(3, 1024, 768, 256, True) == (
        n_pad * 1792 + apad // 2 * (n_pad // 2) * 256)
    assert pipeline.PIPELINE_BYTES >= 2 * pipeline.LAUNCH_BYTES


@pytest.mark.parametrize("mini", [2, 8, 128])
def test_bucket_floor_is_the_largest_bucket_within(mini):
    """``_bucket_floor(n)`` is a bucket of ``_bucket``'s grid, at most
    ``n``, and the next bucket passes ``n``."""
    for n in range(0, 20000):
        b = pipeline._bucket_floor(n, mini)
        assert pipeline._bucket(b, mini) == b
        assert b <= n or b == mini
        assert pipeline._bucket(b + 1, mini) > n


def test_extend_segments_band_above_2048_matches():
    """A segment whose padded band buckets to W 3072, past the 2048 lanes
    the port's K1 once took: scores, transcript and start cells equal
    the JAX package's (its default engine), and the score is 13.0."""
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


def test_extend_segments_band_above_4096_matches():
    """A segment whose padded band buckets to W 6144, which the card
    runs as a cluster of blocks: the port on the CPU gives the JAX
    package's Pallas route (interpret mode) its score 133.0, transcript
    and start cells exactly."""
    codes = np.random.default_rng(3).integers(0, 4, 150).astype(np.int8)
    mut = codes.copy()
    mut[::17] = (mut[::17] + 1) % 4
    S, T = Sequence(A4, codes), Sequence(A4, mut)
    segments = [{"segment": ((-2100, 2100), (100, 200))}]
    cut = pipeline.cut_segment(segments[0], len(S), len(T))
    assert pipeline.plan_launches([cut], True)[0][3] == 6144
    kw = dict(subst=UNIT, go_score=-2.0, ge_score=-1.0,
              with_transcripts=True, pad_a=16, _r_chunk=16)
    want = ref_pipeline.extend_segments(S, T, segments, use_pallas=True,
                                        _interpret=True, **kw)
    got = pipeline.extend_segments(from_reference(S), from_reference(T),
                                   segments, device="cpu", **kw)
    assert got == want
    assert got[0]["score"] == 133.0 and got[0]["transcript"]
    for seg in got:
        aln = Alignment(S, T, seg["transcript"],
                        origin_start=seg["origin_start"],
                        mutate_start=seg["mutate_start"])
        assert aln.calculate_score(UNIT, -2.0, -1.0) == seg["score"]


def test_window_split_bounds_a_wide_band():
    """A band of 30001 diagonals (W 32768: a cluster of 8 blocks a plane
    row on the card) over 200,001 antidiagonals: the split sizes its
    a-windows by that W, ``max(2 * budget // W, 8 * pad_a)`` of them a
    window and its overlap, and every launch of the plan fits the
    launch budget."""
    seg = {"segment": ((-15000, 15000), (0, 200_000))}
    rows, src, _, launches = pipeline.extension_plan([seg], 120_000,
                                                     120_000, True)
    assert {launch[3] for launch in launches} == {32768}
    max_a = max(2 * pipeline.DIRS_BUDGET // 32768, 8 * pipeline.PAD_A)
    spans = [row["segment"][1] for row in rows]
    assert len(rows) == -(-200_001 // max_a) and src == [0] * len(rows)
    assert spans[0][0] == 0 and spans[-1][1] == 200_000
    for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
        assert hi - lo <= max_a + 2 * pipeline.PAD_A
        assert lo2 <= hi - 2 * pipeline.PAD_A
    for idxs, LS, LT, W in launches:
        assert pipeline.launch_bytes(len(idxs), LS, LT, W, True) \
            <= pipeline.LAUNCH_BYTES


def _discovery_pair(seed, n_cores=2, core=250):
    """Planted homologous cores between random spacers (the reference's
    mutation process), for discovery and extension in one call."""
    rng = np.random.default_rng(seed)
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.03, ge_prob=0.1,
                        rng=rng)
    S, T = rand_seq(A4, 150, rng=rng), rand_seq(A4, 90, rng=rng)
    for k in range(n_cores):
        c = rand_seq(A4, core, rng=rng)
        S = S + c + rand_seq(A4, 200 + 50 * k, rng=rng)
        T = T + M.mutate(c)[0] + rand_seq(A4, 260 - 40 * k, rng=rng)
    return S, T


@pytest.mark.parametrize("seed,kw", [
    (21, dict(wordlen=8, K_min=100, p_min=0.6, g_max=0.2)),
    (22, dict(wordlen=7, K_min=120, p_min=0.5, g_max=0.15)),
])
def test_discover_and_extend_matches_composed_reference(seed, kw):
    """The port's one call against the JAX package's steps composed:
    WordBlot discovery, extension by the Pallas kernels in interpret
    mode, sorted by score.  Segments, scores, transcripts and start
    cells equal."""
    S, T = _discovery_pair(seed)
    ekw = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0)
    segments = list(WordBlot(S, T, wordlen=kw["wordlen"], g_max=kw["g_max"])
                    .similar_segments(K_min=kw["K_min"], p_min=kw["p_min"]))
    assert len(segments) >= 2
    want = sorted(ref_pipeline.extend_segments(
        S, T, segments, use_pallas=True, _interpret=True, _r_chunk=16,
        with_transcripts=True, **ekw), key=lambda s: -s["score"])
    got = pipeline.discover_and_extend(
        from_reference(S), from_reference(T), with_transcripts=True,
        device="cpu", **kw, **ekw)
    key = lambda out: [(s["segment"], s["num_seeds"], s["score"],
                        s["transcript"], s["origin_start"],
                        s["mutate_start"], s["source_index"]) for s in out]
    assert key(got) == key(want)
    np.testing.assert_allclose([s["p"] for s in got], [s["p"] for s in want],
                               rtol=1e-5, atol=1e-6)
    _rescores(S, T, got)
    # score-only: the same scores, no transcripts (use_pallas=None
    # leaves the route to the device: the CPU's plain twins)
    plain = pipeline.discover_and_extend(from_reference(S),
                                         from_reference(T), device="cpu",
                                         use_pallas=None, **kw, **ekw)
    assert [s["score"] for s in plain] == [s["score"] for s in got]
    assert all("transcript" not in s for s in plain)


def test_discover_and_extend_use_pallas_contradicting_the_device():
    """``use_pallas=True`` asks for the kernels, which the CPU does not
    run: it raises before any work instead of being ignored."""
    S, T = _discovery_pair(21)
    with pytest.raises(ValueError, match="use_pallas=True contradicts"):
        pipeline.discover_and_extend(from_reference(S), from_reference(T),
                                     use_pallas=True, device="cpu")


def test_discovered_segment_split_into_windows():
    """A segment the port discovers, extended under a small direction-plane
    budget, splits into overlapping a-windows: the rows joined on
    ``source_index`` cover the segment, equal the JAX package's windows,
    and every window's transcript rescores to its score."""
    S, T = _discovery_pair(23, n_cores=1, core=1200)
    wb = port_blot.WordBlot(from_reference(S), from_reference(T), wordlen=8,
                            g_max=0.15, device="cpu")
    segments = list(wb.similar_segments(K_min=300, p_min=0.6))
    assert len(segments) == 1
    # windows of at most 2 * budget / W = 2048 antidiagonals (W 128)
    kw = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0, pad_a=128,
              with_transcripts=True, _dirs_budget=1 << 17)
    got = pipeline.extend_segments(from_reference(S), from_reference(T),
                                   segments, device="cpu", **kw)
    want = ref_pipeline.extend_segments(S, T, segments, use_pallas=False,
                                        **kw)
    assert len(got) > len(segments)
    # the plan extend_segments launched, as extension_plan gives it
    rows, src_idx, _, launches = pipeline.extension_plan(
        segments, len(S), len(T), True, pad_a=128, dirs_budget=1 << 17)
    assert [r["segment"] for r in rows] == [s["segment"] for s in got]
    assert src_idx == [s["source_index"] for s in got]
    assert sum(len(idxs) for idxs, *_ in launches) == len(got)
    strip = lambda out: [(s["segment"], s["source_index"], s["score"],
                          s["transcript"], s["origin_start"],
                          s["mutate_start"]) for s in out]
    assert strip(got) == strip(want)
    (d_lo, d_hi), (a_lo, a_hi) = segments[0]["segment"]
    windows = sorted(s["segment"][1] for s in got if s["source_index"] == 0)
    assert windows[0][0] == a_lo and windows[-1][1] == a_hi
    assert all(w0[1] >= w1[0] for w0, w1 in zip(windows, windows[1:]))
    assert all(s["segment"][0] == (d_lo, d_hi) for s in got)
    _rescores(S, T, got)
    assert max(s["score"] for s in got) > 100
