"""The plain reference: against a cell-by-cell Gotoh recurrence written
out in Python, against the program's CPU twins, and its rescoring of
transcripts."""

import numpy as np
import pytest
import torch

import tiny
from harness import core, generate
from reference import align, cut as refcut

NEG = float("-inf")


def naive(s, t, lo, hi, subst, go, ge):
    """Local affine-gap score in the diagonals [lo, hi], cell by cell."""
    n, m = len(s), len(t)
    H = [[NEG] * (m + 1) for _ in range(n + 1)]
    E = [[NEG] * (m + 1) for _ in range(n + 1)]
    F = [[NEG] * (m + 1) for _ in range(n + 1)]
    best = 0.0
    for i in range(n + 1):
        for j in range(m + 1):
            if not lo <= i - j <= hi:
                continue
            if i == 0 or j == 0:
                H[i][j] = 0.0
                continue
            E[i][j] = max(H[i][j - 1] + go + ge, E[i][j - 1] + ge)
            F[i][j] = max(H[i - 1][j] + go + ge, F[i - 1][j] + ge)
            H[i][j] = max(0.0, H[i - 1][j - 1] + subst[s[i - 1], t[j - 1]],
                          E[i][j], F[i][j])
            best = max(best, H[i][j])
    return best


def test_reference_equals_the_recurrence_cell_by_cell():
    rng = np.random.default_rng(7)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0)
    s_list, t_list, bands, want = [], [], [], []
    for _ in range(24):
        s = rng.integers(0, 4, int(rng.integers(1, 40))).astype(np.int8)
        t = s.copy() if rng.random() < 0.5 else rng.integers(
            0, 4, int(rng.integers(1, 40))).astype(np.int8)
        t = t[: int(rng.integers(1, len(t) + 1))]
        lo = int(rng.integers(-20, 5))
        hi = lo + int(rng.integers(0, 25))
        s_list.append(s)
        t_list.append(t)
        bands.append((lo, hi))
        want.append(naive(s, t, lo, hi, subst, -3.0, -1.0))
    got = align.local_scores(s_list, t_list, bands, subst, -3.0, -1.0)
    np.testing.assert_array_equal(got, want)
    # an affine gap: one open, the rest extends
    s = np.array([0, 1, 2, 3, 0, 1, 2, 3, 3, 3, 3, 0, 1, 2, 3], np.int8)
    t = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3], np.int8)
    got = align.local_scores([s], [t], [(-5, 5)], subst, -3.0, -1.0)
    assert got[0] == naive(s, t, -5, 5, subst, -3.0, -1.0) == 8.0


def test_rescore_reads_scores_bands_and_letters():
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0)
    s = np.array([0, 1, 2, 3, 0], np.int8)
    t = np.array([0, 1, 3, 3, 2, 0], np.int8)
    cut = (0, 5, 0, 6, -3, 3)
    assert align.rescore("MMSM", 0, 0, s, t, cut, (-3, 3), subst, -3.0,
                         -1.0) == (2.0, True)
    # I then D opens twice: 2 + (-4) + (-4)
    assert align.rescore("MMID", 0, 0, s, t, cut, (-3, 3), subst, -3.0,
                         -1.0) == (-6.0, True)
    # a mismatch called a match, a path off the band, a stray letter
    assert not align.rescore("MMMM", 0, 0, s, t, cut, (-3, 3), subst, -3.0,
                             -1.0)[1]
    assert not align.rescore("MMIII", 0, 0, s, t, cut, (-1, 3), subst,
                             -3.0, -1.0)[1]
    assert not align.rescore("MMX", 0, 0, s, t, cut, (-3, 3), subst, -3.0,
                             -1.0)[1]


def test_bfloat16_loses_scores_past_256():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, 600).astype(np.int8)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0)
    f32 = align.local_scores([s], [s], [(-8, 8)], subst, -3.0, -1.0)
    bf16 = align.local_scores([s], [s], [(-8, 8)], subst, -3.0, -1.0,
                              dtype=torch.bfloat16)
    assert f32[0] == 600.0 and bf16[0] != 600.0


def test_frozen_geometry_is_the_programs():
    from biseqt_tpu_torch import pipeline

    g = generate.generator(11, "cpu")
    s, t, segments = generate.planted_pairs(g, 5, tiny.config())
    rows, src, cut, _ = pipeline.extension_plan(segments, len(s), len(t),
                                                True)
    mine = refcut.rows_of(segments, len(s), len(t), True)
    assert [(k, r["segment"], c) for k, r, c in zip(src, rows, cut)] == mine
    # a long segment split into windows
    long = [{"segment": ((-400, 400), (0, 5_000_000))}]
    rows, src, cut, _ = pipeline.extension_plan(long, 3_000_000, 3_000_000,
                                                True)
    mine = refcut.rows_of(long, 3_000_000, 3_000_000, True)
    assert len(mine) > 1
    assert [(k, r["segment"], c) for k, r, c in zip(src, rows, cut)] == mine


def test_program_on_the_cpu_equals_the_reference():
    entry = core.load("entries", "extend_segments").Entry(
        tiny.config(), tiny.traffic(), 20261018, "cpu")
    done = [(k, entry.call(k)) for k in range(len(entry))]
    checks, failed = entry.judge(done)
    assert checks == {"ref_gap": (0.0, 0.0)} and failed == 0
    ref = entry.reference_scores()
    assert all((r > 100).all() for r in ref)


@pytest.mark.cuda
def test_rows_replayed_from_graphs_equal_the_loop_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0)
    s_list = [rng.integers(0, 4, int(n)).astype(np.int8)
              for n in rng.integers(600, 2000, 6)]
    t_list = [np.concatenate([s[5:], rng.integers(0, 4, 50)]).astype(np.int8)
              for s in s_list]
    bands = [(-40, 60), (-10, 10), (0, 127), (-200, -100), (3, 3), (-5, 90)]
    cpu = align.local_scores(s_list, t_list, bands, subst, -3.0, -1.0)
    card = align.local_scores(s_list, t_list, bands, subst, -3.0, -1.0,
                              device="cuda")
    np.testing.assert_array_equal(card, cpu)
    assert cpu.max() > 500
