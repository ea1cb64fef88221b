"""The port's row route, ``extend_segments(use_pallas=False)`` and
``discover_and_extend(use_pallas=False)``, against the JAX package's:
the row-wavefront engine over the whole band, its direction bytes
walked on the host by ``native.traceback_batch``.  Also the port's
bindings ``native.traceback_batch`` and ``native.compact_sweep_ops``
against the JAX package's on the same inputs.  Tolerance is exact:
scores, transcripts, start cells and source indices equal.
"""

import importlib.util
import os

import numpy as np
import pytest
import jax.numpy as jnp

import biseqt_tpu.pipeline as ref_pipeline
from biseqt_tpu import native as ref_native
from biseqt_tpu.ops.banded_dp import ModeFlags as RefFlags
from biseqt_tpu.ops.banded_dp import banded_dp as ref_banded_dp
from biseqt_tpu.ops.pallas_walk import traceback_sweep
from biseqt_tpu.blot import WordBlot
from biseqt_tpu.sequence import Alphabet, Sequence
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import native, pipeline
from biseqt_tpu_torch.ops.banded_dp import ModeFlags
from biseqt_tpu_torch.ops.dp_ad import banded_dp_ad, parity_adjusted_dmin
from biseqt_tpu_torch.sequence import from_reference
from test_torch_cuda import UNIT, mk_batch
from test_torch_pipeline import (QUEUE_KW, _discovery_pair, _planted_blocks,
                                 _rescores)

A4 = Alphabet("ACGT")
TX = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0, with_transcripts=True)
# local, global and overlap modes
FLAG_CASES = [
    dict(local_start=True, local_end=True),
    dict(),
    dict(free_start_edges=True, free_end_edges=True),
]


def _repro_pair(seed, core_len=3000):
    """A random core between spacers in S, the core through the JAX
    package's mutation process (15% substitutions, gap open 0.05,
    extend 0.2) between other spacers in T, and JAX Word-Blot's
    segments (word length 8, g_max 0.3, K_min 300, p_min 0.5)."""
    rng = np.random.default_rng(seed)
    M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    core = rng.integers(0, 4, core_len)
    S = Sequence(A4, np.concatenate([rng.integers(0, 4, 200), core,
                                     rng.integers(0, 4, 100)]))
    mutated = M.mutate(Sequence(A4, core))[0]
    T = (Sequence(A4, rng.integers(0, 4, 50)) + mutated
         + Sequence(A4, rng.integers(0, 4, 300)))
    segments = list(WordBlot(S, T, wordlen=8, g_max=0.3)
                    .similar_segments(K_min=300, p_min=0.5))
    return S, T, segments


@pytest.mark.parametrize("seed,n_segments,twins_differ", [
    (14, 9, 3), (11, 7, None)])
def test_row_route_matches_jax_on_the_repro(seed, n_segments, twins_differ):
    """Both packages' ``use_pallas=False`` give the same scores,
    transcripts, start cells and source indices.  At seed 14 the plain
    twins of the kernels (``use_pallas=None`` on the CPU, the JAX
    package's route on its accelerator) score every segment the same
    but pick other alignments among equal-scoring ones for 3 of 9."""
    S, T, segments = _repro_pair(seed)
    assert len(segments) == n_segments
    want = ref_pipeline.extend_segments(S, T, segments, use_pallas=False,
                                        **TX)
    pS, pT = from_reference(S), from_reference(T)
    got = pipeline.extend_segments(pS, pT, segments, use_pallas=False,
                                   device="cpu", **TX)
    assert got == want
    _rescores(S, T, got)
    if twins_differ is None:
        return
    twins = pipeline.extend_segments(pS, pT, segments, use_pallas=None,
                                     device="cpu", **TX)
    assert [s["score"] for s in twins] == [s["score"] for s in want]
    assert sum(a != b for a, b in zip(twins, want)) == twins_differ


@pytest.mark.parametrize("with_transcripts", [False, True])
def test_row_route_uses_the_whole_band(with_transcripts):
    """A 600 bp sequence against itself, the segment's padded band 128
    diagonals wide (W 128) with the identity on its lowest diagonal: the
    row route keeps that diagonal and scores 600.0, as the JAX package's
    does; K1's route drops it (``w_eff`` at most W - 1) and scores 9.0."""
    S = rand_seq(A4, 600, rng=np.random.default_rng(5))
    segments = [{"segment": ((16, 111), (200, 1000))}]
    cut = pipeline.cut_segment(segments[0], len(S), len(S))
    assert pipeline.plan_launches([cut], True, row=True)[0][3] == 128
    assert cut[5] - cut[4] + 1 == 128           # the band's diagonals
    kw = dict(subst=UNIT, with_transcripts=with_transcripts)
    want = ref_pipeline.extend_segments(S, S, segments, use_pallas=False,
                                        **kw)
    pS = from_reference(S)
    got = pipeline.extend_segments(pS, pS, segments, use_pallas=False,
                                   device="cpu", **kw)
    assert got == want
    assert got[0]["score"] == 600.0
    if with_transcripts:
        assert got[0]["transcript"] == "M" * 600
    twins = pipeline.extend_segments(pS, pS, segments, device="cpu", **kw)
    assert twins[0]["score"] == 9.0


def test_row_route_window_split_matches():
    """A segment longer than a small direction-plane budget splits into
    overlapping a-windows; the row route gives the JAX package's
    windows, scores, transcripts and start cells."""
    rng = np.random.default_rng(3)
    M = MutationProcess(A4, subst_probs=0.06, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    S = rand_seq(A4, 3000, rng=rng)
    T, _ = M.mutate(S)
    segments = list(WordBlot(S, T, wordlen=8, g_max=0.15)
                    .similar_segments(K_min=600, p_min=0.6))
    assert segments
    kw = dict(TX, _dirs_budget=1)
    want = ref_pipeline.extend_segments(S, T, segments, use_pallas=False,
                                        **kw)
    got = pipeline.extend_segments(S, T, segments, use_pallas=False,
                                   device="cpu", **kw)
    assert len(got) > len(segments)
    assert got == want
    _rescores(S, T, got)


@pytest.mark.parametrize("with_transcripts", [False, True])
def test_discover_and_extend_row_route_matches(with_transcripts):
    """The port's one call with ``use_pallas=False`` against the JAX
    package's: segments, seed counts, scores, transcripts and start
    cells equal, p-hat within rtol 1e-5, atol 1e-6."""
    S, T = _discovery_pair(21)
    kw = dict(wordlen=8, K_min=100, p_min=0.6, g_max=0.2, subst=UNIT,
              go_score=-3.0, ge_score=-1.0,
              with_transcripts=with_transcripts, use_pallas=False)
    want = ref_pipeline.discover_and_extend(S, T, **kw)
    got = pipeline.discover_and_extend(from_reference(S), from_reference(T),
                                       device="cpu", **kw)
    assert len(got) >= 2
    fields = ("segment", "num_seeds", "score", "source_index",
              "transcript", "origin_start", "mutate_start")
    key = lambda out: [tuple(s.get(f) for f in fields) for s in out]
    assert key(got) == key(want)
    np.testing.assert_allclose([s["p"] for s in got], [s["p"] for s in want],
                               rtol=1e-5, atol=1e-6)
    if with_transcripts:
        _rescores(S, T, got)


@pytest.mark.parametrize("budget", [0, "default"])
@pytest.mark.parametrize("with_transcripts", [False, True])
def test_row_route_in_flight_budget_changes_nothing(monkeypatch, budget,
                                                    with_transcripts):
    """The row route over many launches (two pairs each), finished one at
    a time (``PIPELINE_BYTES`` 0) or kept in flight (the default): the
    JAX package's output, byte for byte.  The row route launches no
    kernel and counts its byte plane against the budget."""
    S, T, segments = _planted_blocks(np.random.default_rng(17))
    kw = dict(QUEUE_KW, with_transcripts=with_transcripts)
    kw.pop("_r_chunk")
    if not with_transcripts:
        segments = pipeline.extension_plan(segments, len(S), len(T), True,
                                           pad_a=kw["pad_a"],
                                           dirs_budget=1)[0]
    want = ref_pipeline.extend_segments(S, T, segments, use_pallas=False,
                                        **kw)
    monkeypatch.setattr(pipeline, "LAUNCH_BYTES", 1)
    if budget == 0:
        monkeypatch.setattr(pipeline, "PIPELINE_BYTES", 0)
    order = []
    dispatch, finish = pipeline._dispatch, pipeline._finish
    monkeypatch.setattr(pipeline, "_dispatch",
                        lambda *a: order.append(a[5]) or dispatch(*a))
    monkeypatch.setattr(pipeline, "_finish",
                        lambda *a: order.append("F") or finish(*a))
    monkeypatch.setattr(pipeline, "banded_dp_ad", None)    # never called
    got = pipeline.extend_segments(from_reference(S), from_reference(T),
                                   segments, use_pallas=False, device="cpu",
                                   **kw)
    assert got == want
    n = order.count("row")
    assert n >= 3 and len(got) >= 20 and order.count("F") == n
    if budget == 0:
        assert order == ["row", "F"] * n
    else:
        assert order == ["row"] * n + ["F"] * n
    if with_transcripts:
        _rescores(S, T, got)


def test_smoke_row_route_constants_are_the_jax_cpu_runs():
    """``chip_smoke.py`` phase 17 holds the card to constants: (c)'s
    ``ROW_ROUTE_JAX_CPU`` is the JAX package's ``discover_and_extend(
    use_pallas=False)`` on the CPU on ``rearranged_pair``'s codes, and
    (b)'s ``BAND_FILL`` scores are the JAX row route's and the port's
    K1 route's (its twins) on the same sequence."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rr = cs.ROW_ROUTE
    a, b, _ = cs.rearranged_pair(np, np.random.default_rng(rr["seed"]),
                                 rr["size"], rr["blocks"], cs.GENOME["sub"],
                                 cs.GENOME["gap"])
    found = ref_pipeline.discover_and_extend(
        Sequence(A4, a), Sequence(A4, b), wordlen=rr["wordlen"],
        g_max=rr["g_max"], p_min=rr["p_min"],
        K_min=rr["size"] // rr["blocks"] // 8, subst=UNIT,
        go_score=cs.GO, ge_score=cs.GE, with_transcripts=True,
        use_pallas=False)
    assert dict(n_segments=len(found), scores=[r["score"] for r in found],
                tx_total_ops=sum(len(r["transcript"]) for r in found),
                sha1=cs.row_digest(found)) == cs.ROW_ROUTE_JAX_CPU
    bf = cs.BAND_FILL
    S = Sequence(A4, np.random.default_rng(bf["seed"]).integers(
        0, 4, bf["length"]))
    segments = [{"segment": bf["segment"]}]
    kw = dict(subst=UNIT, go_score=cs.GO, ge_score=cs.GE)
    row = ref_pipeline.extend_segments(S, S, segments, use_pallas=False,
                                       **kw)
    k1 = pipeline.extend_segments(S, S, segments, device="cpu", **kw)
    assert (row[0]["score"], k1[0]["score"]) == (bf["row_score"],
                                                 bf["k1_score"])


def test_launch_bytes_counts_the_row_plane():
    """On the row route a transcript launch counts its padded codes and
    its ``[n_pad, LS, W]`` byte plane; the plan caps a launch by that
    plane, so the smoke's 2048-pair group still fits one launch."""
    n_pad = 4                       # _bucket(3, 2)
    assert pipeline.launch_bytes(3, 1024, 768, 256, True, row=True) == (
        n_pad * 1792 + n_pad * 1024 * 256)
    assert pipeline.launch_bytes(3, 1024, 768, 256, False, row=True) == (
        pipeline.launch_bytes(3, 1024, 768, 256, False))
    cuts = [(0, 11_024, 0, 11_020, -66 + k % 3, 66 + k % 3)
            for k in range(2048)]
    launches = pipeline.plan_launches(cuts, True, row=True)
    assert [len(idxs) for idxs, *_ in launches] == [2048]
    LS, W = 12288, 256
    assert 2048 * (LS * W + 2 * LS + 2 * W) <= pipeline.LAUNCH_BYTES
    assert 4096 * LS * W > pipeline.LAUNCH_BYTES


def _lax_planes(rng, flags):
    """The JAX package's row engine on a ragged batch (mixed band
    starts, per-pair widths): its direction bytes, end cells and the
    batch."""
    (ss, ts, s_lens, t_lens, dmin), w_eff = mk_batch(rng)
    res = ref_banded_dp(jnp.asarray(ss), jnp.asarray(ts),
                        jnp.asarray(s_lens), jnp.asarray(t_lens),
                        jnp.asarray(dmin), W=128, subst=UNIT, go=-2.0,
                        ge=-1.0, flags=RefFlags(**flags), with_dirs=True,
                        w_eff=jnp.asarray(w_eff))
    walk = (np.asarray(res.dirs), dmin + 127, ss, ts, s_lens, t_lens,
            np.asarray(res.end_i), np.asarray(res.end_j))
    return walk, np.asarray(res.score)


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_traceback_batch_matches_the_jax_binding(rng, flags):
    """``native.traceback_batch`` over the JAX row engine's planes gives
    the JAX binding's transcripts and start cells, for local, global and
    overlap modes."""
    walk, score = _lax_planes(rng, flags)
    f = RefFlags(**flags)
    ops, si, sj = native.traceback_batch(*walk, f)
    r_ops, r_si, r_sj = ref_native.traceback_batch(*walk, f)
    assert ops == r_ops
    np.testing.assert_array_equal(si, r_si)
    np.testing.assert_array_equal(sj, r_sj)
    # one pair's band misses its homology (mk_batch's third pair)
    assert sum(len(o) > 100 for o in ops) >= 4
    if not flags:                       # global: from (0, 0)
        assert not si.any() and not sj.any()


def test_traceback_batch_refuses_what_it_cannot_walk(rng):
    """A wrong ``dmax`` sends the walk off the plane (``RuntimeError``);
    per-pair arrays that do not hold the plane's pairs, or an end cell
    outside its matrix, raise ``ValueError`` before the C++ walk."""
    walk, _ = _lax_planes(rng, FLAG_CASES[0])
    f = RefFlags(**FLAG_CASES[0])
    dirs, dmax, ss, ts, s_lens, t_lens, ei, ej = walk
    with pytest.raises(RuntimeError, match="left the direction plane"):
        native.traceback_batch(dirs, dmax + 128, *walk[2:], f)
    # the JAX pipeline's call: the padded plane with the real pairs' arrays
    with pytest.raises(ValueError, match="plane holds 5 pairs"):
        native.traceback_batch(dirs, dmax[:3], ss[:3], ts[:3], s_lens[:3],
                               t_lens[:3], ei[:3], ej[:3], f)
    with pytest.raises(ValueError, match="plane holds 5 pairs"):
        native.traceback_batch(dirs, dmax, ss, ts, s_lens, t_lens, ei[:4],
                               ej, f)
    bad_end = ei.copy()
    bad_end[1] = s_lens[1] + 1
    with pytest.raises(ValueError, match="end cells outside"):
        native.traceback_batch(dirs, dmax, ss, ts, s_lens, t_lens, bad_end,
                               ej, f)
    # the first n pairs of the plane walk as the whole plane's first n
    ops, si, sj = native.traceback_batch(dirs[:3], dmax[:3], ss[:3], ts[:3],
                                         s_lens[:3], t_lens[:3], ei[:3],
                                         ej[:3], f)
    full = native.traceback_batch(*walk, f)
    assert ops == full[0][:3]
    np.testing.assert_array_equal(si, full[1][:3])


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_compact_sweep_ops_matches_the_jax_binding(rng, flags):
    """``native.compact_sweep_ops`` over the JAX sublane walk's traces
    (``traceback_sweep`` in interpret mode, on the port's K1 plane)
    gives the JAX binding's transcripts and start cells, the anchored
    modes' (0, 0) start included, and the port's lane-packed walk's."""
    args, w_eff = mk_batch(rng)
    ss, ts, s_lens, t_lens, dmin = args
    f = ModeFlags(**flags)
    res = banded_dp_ad(*args, W=128, subst=UNIT, go=-2.0, ge=-1.0, flags=f,
                       w_eff=w_eff, with_dirs=True, r_chunk=16, device="cpu")
    dminq = parity_adjusted_dmin(dmin, np.arange(len(ss)) % 2).astype(
        np.int32)
    live = res.score.numpy() > -1e29
    ei = np.where(live, res.end_i.numpy(), -1).astype(np.int32)
    ej = np.where(live, res.end_j.numpy(), -1).astype(np.int32)
    tr0, tr1, fi, fj = (np.asarray(x) for x in traceback_sweep(
        jnp.asarray(res.dirs.numpy()), jnp.asarray(dminq), jnp.asarray(ei),
        jnp.asarray(ej), W=128, block_b=8, r_rows=8, interpret=True))
    ops, si, sj = native.compact_sweep_ops(tr0, tr1, fi, fj, ss, ts, s_lens,
                                           t_lens, f)
    r_ops, r_si, r_sj = ref_native.compact_sweep_ops(tr0, tr1, fi, fj, ss,
                                                     ts, RefFlags(**flags))
    assert ops == r_ops
    np.testing.assert_array_equal(si, r_si)
    np.testing.assert_array_equal(sj, r_sj)
    h_ops, h_si, h_sj = native.traceback_batch_ad(
        res.dirs.numpy(), dminq, ss, ts, s_lens, t_lens, res.end_i.numpy(),
        res.end_j.numpy(), f)
    for b in np.nonzero(live)[0]:
        assert (ops[b], si[b], sj[b]) == (h_ops[b], h_si[b], h_sj[b])
    assert live.sum() >= len(ss) - 1
    if not flags:
        assert not si[live].any() and not sj[live].any()

    # refused: traces of two shapes, cursors outside their matrix
    with pytest.raises(ValueError, match="must both be"):
        native.compact_sweep_ops(tr0, tr1[:, :-1], fi, fj, ss, ts, s_lens,
                                 t_lens, f)
    far = fi.copy()
    far[np.argmax(live)] = s_lens[np.argmax(live)] + 1
    with pytest.raises(ValueError, match="outside their pair's matrix"):
        native.compact_sweep_ops(tr0, tr1, far, fj, ss, ts, s_lens, t_lens,
                                 f)
