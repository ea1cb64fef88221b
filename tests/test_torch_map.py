"""Read mapping (``biseqt_tpu_torch.pipeline.map_reads``) on the CPU: a
50 kbp reference, 6 reads of 2 kbp through the mutation channel, word
10, K_min 500, on both Word-Blot assemblers (the sparse one reached by
lowering ``WordBlot.MAX_GRID_CELLS``).

Held to the benchmark's plain reference (``benchmark/reference/
mapping.py``: segments, seed counts and the best choice exact, p and S0
to rtol 1e-5, every row's score the exact banded optimum and every
transcript rescoring to it) and to the JAX package's
``WordBlotLocalRef.similar_segments_batch`` and ``extend_segments``
composed read by read (rows equal).  S1 is held to the float64
reference within 1e-4 absolute as well: at a segment's own rate (z near
0, S1 near log 2) float32's mu1 = K p^w cancels against n, ~1e-5 of
S1 there.
"""

import os
import sys

import numpy as np
import pytest
import torch

import biseqt_tpu.blot as jax_blot
import biseqt_tpu.pipeline as jax_pipeline
from biseqt_tpu.sequence import Alphabet
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import blot, pipeline
from biseqt_tpu_torch.sequence import Alphabet as PortAlphabet
from biseqt_tpu_torch.sequence import Sequence, from_reference

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from reference import align, cut as refcut, mapping  # noqa: E402

A4 = Alphabet("ACGT")
P4 = PortAlphabet("ACGT")
UNIT = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
REF_LEN, READ_LEN, N_READS = 50_000, 2000, 6
WORD, G_MAX, K_MIN, P_MIN = 10, 0.25, 500, 0.5
KW = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0, with_transcripts=True)


@pytest.fixture(scope="module")
def inputs():
    """The reference, the reads (JAX package sequences) and each read's
    locus."""
    rng = np.random.default_rng(22)
    ref = rand_seq(A4, REF_LEN, rng=rng)
    M = MutationProcess(A4, subst_probs=0.06, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    reads, loci = [], []
    for _ in range(N_READS):
        r0 = int(rng.integers(0, REF_LEN - READ_LEN))
        reads.append(M.mutate(ref[r0:r0 + READ_LEN])[0])
        loci.append(r0)
    return ref, reads, loci


@pytest.fixture(scope="module", params=["dense", "sparse"])
def mapped(request, inputs):
    """``(assembler, the grid size it needs, map_reads' output, the
    launches it dispatched)`` on the CPU."""
    ref, reads, _ = inputs
    cells = mapping.MAX_GRID_CELLS if request.param == "dense" else 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blot.WordBlot, "MAX_GRID_CELLS", cells)
        dispatched = []
        dispatch = pipeline._dispatch
        mp.setattr(pipeline, "_dispatch", lambda idxs, *a: dispatched.append(
            len(idxs)) or dispatch(idxs, *a))
        mapper = blot.WordBlotLocalRef(from_reference(ref), wordlen=WORD,
                                       g_max=G_MAX, device="cpu")
        out = pipeline.map_reads(mapper, [from_reference(r) for r in reads],
                                 K_min=K_MIN, p_min=P_MIN, device="cpu",
                                 **KW)
    return request.param, cells, out, dispatched


def test_map_reads_matches_the_plain_reference(inputs, mapped):
    ref, reads, loci = inputs
    _, cells, out, dispatched = mapped
    table = mapping.RefTable(ref.to_array(), WORD, 4)
    s_list, t_list, bands, rows = [], [], [], []
    for q, (read, o) in enumerate(zip(reads, out)):
        want = mapping.similar_segments(read.to_array(), table, G_MAX, K_MIN,
                                        P_MIN, max_grid_cells=cells)
        key = lambda s: (tuple(map(tuple, s["segment"])), s["num_seeds"])
        assert [key(s) for s in o["segments"]] == [key(s) for s in want]
        for g, w in zip(o["segments"], want):
            np.testing.assert_allclose([g["p"], g["score"][0]],
                                       [w["p"], w["score"][0]], rtol=1e-5)
            np.testing.assert_allclose(g["score"][1], w["score"][1],
                                       rtol=1e-5, atol=1e-4)
        b = mapping.best(want)
        assert b is not None and o["best"] == b
        # the best segment lies on the read's locus
        (d_lo, d_hi), _ = want[b]["segment"]
        assert d_lo - 200 <= -loci[q] <= d_hi + 200
        cut_rows = refcut.rows_of([want[b]], len(read), REF_LEN, True)
        assert len(o["rows"]) == len(cut_rows) == 1
        for (_, _, c), r in zip(cut_rows, o["rows"]):
            s_list.append(read.to_array()[c[0]:c[1]])
            t_list.append(ref.to_array()[c[2]:c[3]])
            bands.append(refcut.band(c))
            tx, ok = align.rescore(r["transcript"], r["origin_start"],
                                   r["mutate_start"], read.to_array(),
                                   ref.to_array(), c, refcut.band(c), UNIT,
                                   -3.0, -1.0)
            assert ok and tx == r["score"]
            assert r["source_index"] == 0
            assert r["band_cells"] == refcut.band_cells(c)
            rows.append(r)
    scores = align.local_scores(s_list, t_list, bands, UNIT, -3.0, -1.0)
    assert [r["score"] for r in rows] == scores.tolist()
    assert all(r["score"] > 1000 for r in rows)
    # every read's row in a launch shared with other reads'
    assert sum(dispatched) == N_READS and len(dispatched) < N_READS


def test_map_reads_matches_the_jax_package_read_by_read(inputs, mapped):
    """The JAX package's batch discovery gives the same segments; on the
    dense assembler each read's best segment, extended alone by the JAX
    package (its kernels in interpret mode), gives the same rows, byte
    for byte.  (The sparse assembler's rows are held to the plain
    reference above: each JAX extension here takes ~12 s.)"""
    ref, reads, _ = inputs
    assembler, cells, out, _ = mapped
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blot.WordBlot, "MAX_GRID_CELLS", cells)
        want = jax_blot.WordBlotLocalRef(ref, wordlen=WORD, g_max=G_MAX) \
            .similar_segments_batch(reads, K_min=K_MIN, p_min=P_MIN)
    for o, segs in zip(out, want):
        assert [s["segment"] for s in o["segments"]] == \
            [s["segment"] for s in segs]
        assert [s["num_seeds"] for s in o["segments"]] == \
            [s["num_seeds"] for s in segs]
        np.testing.assert_allclose(
            [[s["p"], *s["score"]] for s in o["segments"]],
            [[s["p"], *s["score"]] for s in segs], rtol=1e-5, atol=1e-6)
        assert o["best"] == max(range(len(segs)),
                                key=lambda k: segs[k]["num_seeds"])
    if assembler == "sparse":
        return
    for read, o in zip(reads, out):
        rows = jax_pipeline.extend_segments(
            read, ref, [o["segments"][o["best"]]], use_pallas=True,
            _interpret=True, _walk_r_rows=8, _r_chunk=16, **KW)
        assert o["rows"] == rows


def test_reads_of_one_shape_share_one_launch(monkeypatch):
    """Four reads of one shape (a locus each, substitutions only) make one
    launch for their four rows, each row the read's own extension of its
    best segment; a read shorter than K_min is unmapped and has none."""
    rng = np.random.default_rng(23)
    ref = rng.integers(0, 4, 20_000).astype(np.int8)
    reads = []
    # loci on one phase of the grid's cells, so the boxes match too
    for r0 in (2000, 6000, 10000, 14000):
        read = ref[r0:r0 + 1000].copy()
        hit = rng.random(1000) < 0.05
        read[hit] = (read[hit] + rng.integers(1, 4, hit.sum())) % 4
        reads.append(Sequence(P4, read))
    reads.insert(2, Sequence(P4, rng.integers(0, 4, 300)))
    dispatched = []
    dispatch = pipeline._dispatch
    monkeypatch.setattr(pipeline, "_dispatch", lambda idxs, *a: (
        dispatched.append(len(idxs)) or dispatch(idxs, *a)))
    mapper = blot.WordBlotLocalRef(Sequence(P4, ref), wordlen=WORD,
                                   g_max=G_MAX, device="cpu")
    out = pipeline.map_reads(mapper, reads, K_min=400, p_min=P_MIN,
                             device="cpu", **KW)
    assert dispatched == [4]
    assert out[2] == {"segments": [], "best": None, "rows": []}
    for read, o in zip(reads, out):
        if o["best"] is None:
            continue
        alone = pipeline.extend_segments(
            read, mapper.ref, [o["segments"][o["best"]]], device="cpu", **KW)
        assert o["rows"] == alone and alone[0]["score"] > 800


def test_map_reads_names_the_mappers_device(monkeypatch):
    """An empty batch maps to nothing; a mapper on another device than the
    call's raises before any work."""
    ref = Sequence(P4, np.zeros(100, np.int8))
    mapper = blot.WordBlotLocalRef(ref, wordlen=WORD, device="cpu")
    assert pipeline.map_reads(mapper, [], K_min=50, p_min=0.5,
                              device="cpu") == []
    monkeypatch.setattr(mapper, "device", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="got a mapper on cuda"):
        pipeline.map_reads(mapper, [ref], K_min=50, p_min=0.5, device="cpu")


@pytest.mark.parametrize("dense_runs", [0, 1 << 10])
def test_served_seeds_do_not_depend_on_the_lookup(inputs, monkeypatch,
                                                  dense_runs):
    """Each window's run of the reference's table, looked up in the dense
    array of run starts or found by binary search, serves the same seeds
    as the plain reference's table."""
    ref, reads, _ = inputs
    monkeypatch.setattr(blot.WordBlotLocalRef, "DENSE_RUNS", dense_runs)
    mapper = blot.WordBlotLocalRef(from_reference(ref), wordlen=WORD,
                                   device="cpu")
    assert (mapper._ref_runs is None) == (dense_runs == 0)
    table = mapping.RefTable(ref.to_array(), WORD, 4)
    for read in reads:
        got = mapper._as_wordblot(blot.WordBlot, from_reference(read)) \
            .seed_index.seed_arrays()
        want = table.seeds(read.to_array())
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
