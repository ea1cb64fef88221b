"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and
skips without one.  The file imports neither jax nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance is exact: the kernels run the plain twins' arithmetic step for
step, so scores, end cells, dirs planes, trace bytes and transcripts
must be equal, and the probes' kernels move or combine integers.  The
batch helpers are shared with the CPU parity tests
(tests/test_torch_dp_ad.py, tests/test_torch_walk.py,
tests/test_torch_dp_row.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from biseqt_tpu_torch import blot, native, pipeline, profiling, pw
from biseqt_tpu_torch.experiments import i16_probe, transpose_probe
from biseqt_tpu_torch.matrices import BLOSUM62, protein_alphabet
from biseqt_tpu_torch.ops import compact, dp_ad, dp_row, steps, walk
from biseqt_tpu_torch.ops.banded_dp import ModeFlags
from biseqt_tpu_torch.pipeline import (discover_and_extend, extend_segments,
                                       extension_plan)
from biseqt_tpu_torch.sequence import Alphabet, Sequence

pytestmark = pytest.mark.cuda

UNIT = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
# every flag set of pw._FLAGS (the main path's local mode first), and one
# that mixes a free start with a local end
FLAG_CASES = [
    dict(local_start=True, local_end=True),
    dict(),
    dict(free_start_edges=True, free_end_edges=True),
    dict(local_end=True),
    dict(local_start=True),
    dict(free_end_edges=True),
    dict(free_start_edges=True),
    dict(free_start_edges=True, local_end=True),
]
GENERAL = np.array(
    [[2, -1, -2, -1], [-1, 2, -1, -2], [-2, -1, 2, -1], [-1, -2, -1, 2]],
    np.float32)
# the bands above 4096 lanes, run as thread-block clusters
CLUSTER_WS = [6144, 8192, 12288, 16384, 24576, 32768, 49152, 65536]


# the hand-written kernels, each counted as ``launches.<kernel>``
KERNELS = ("dp_ad", "walk", "compact", "dp_row", "transpose_probe",
           "i16_probe")


def launches(*kernels):
    """Launches so far of the named kernels (all of ``KERNELS`` when none
    is named), over every span."""
    return sum(profiling.total("launches." + k) for k in kernels or KERNELS)


def random_subst(rng, A):
    """A random ``A x A`` float32 matrix: a positive diagonal, negative
    mismatches of varied (fractional) values."""
    m = -rng.integers(1, 9, (A, A)).astype(np.float32) / 2
    np.fill_diagonal(m, rng.integers(2, 6, A).astype(np.float32))
    return m


def mk_edge_batch(rng, lanes, L=150, A=4):
    """Homologous pairs, one for each lane of ``lanes``, ragged (T a
    letter longer or shorter, with a 3-letter insertion halfway), 15%
    substitutions: returns ``(ss, ts, s_lens, t_lens)``; each caller puts
    pair b's main diagonal on ``lanes[b]``, so the alignment runs along
    that lane and its gap chains cross it."""
    B = len(lanes)
    ss = rng.integers(0, A, (B, L)).astype(np.int8)
    ts = ss.copy()
    m = rng.random((B, L)) < 0.15
    ts[m] = (ts[m] + 1 + rng.integers(0, A - 1, m.sum())) % A
    ts = np.concatenate([ts[:, :L // 2], rng.integers(0, A, (B, 3)),
                         ts[:, L // 2:]], axis=1).astype(np.int8)
    s_lens = np.full(B, L, np.int32)
    t_lens = (L + 3 - np.arange(B) % 3).astype(np.int32)
    return ss, ts, s_lens, t_lens


def cluster_edges(W, lanes_per_block):
    """The lanes at which a cluster's blocks meet, and two lanes near the
    band's edges (an alignment of :func:`mk_edge_batch` drifts three
    lanes at its insertion: down in K1's lanes, up in K4's)."""
    inner = list(range(lanes_per_block, W, lanes_per_block))
    return [4, W - 5] + inner + [x - 1 for x in inner]


def mk_batch(rng):
    """Ragged pairs, mixed dmin parities, per-pair effective widths (the
    batch of tests/test_pallas_dp_ad.py)."""
    B, L = 5, 150
    ss = rng.integers(0, 4, (B, L)).astype(np.int8)
    ts = ss.copy()
    m = rng.random((B, L)) < 0.15
    ts[m] = (ts[m] + 1 + rng.integers(0, 3, m.sum())) % 4
    s_lens = np.array([150, 140, 150, 130, 150], np.int32)
    t_lens = np.array([148, 150, 135, 150, 150], np.int32)
    dmin = np.array([-64, -63, -30, -80, -64], np.int32)
    w_eff = np.array([100, 127, 64, 120, 127], np.int32)
    return (ss, ts, s_lens, t_lens, dmin), w_eff


# the flag sets of tests/test_pallas_dp.py
ROW_FLAGS = [
    dict(),
    dict(local_start=True, local_end=True),
    dict(free_start_edges=True, free_end_edges=True),
    dict(local_end=True),
    dict(local_start=True),
]


def mk_row_batch(rng, A=4, W=128, L=300):
    """Ragged homologous pairs (15% substitutions, T shifted by up to
    three letters) with per-pair bands around the main diagonal and
    effective widths below W."""
    B = 5
    ss = rng.integers(0, A, (B, L)).astype(np.int8)
    ts = ss.copy()
    m = rng.random((B, L)) < 0.15
    ts[m] = (ts[m] + 1 + rng.integers(0, A - 1, m.sum())) % A
    for b in range(B):
        ts[b] = np.roll(ts[b], b % 4)
    s_lens = np.array([L, L - 17, L, L - 60, 1], np.int32)
    t_lens = np.array([L, L, L - 23, L - 55, L], np.int32)
    w_eff = np.array([W, W - 28, W // 2 + 3, W - 1, W], np.int32)
    dmin = (np.array([-(W // 2), -(W // 2) - 9, -40, -(W // 2) + 5, -W + 2])
            .astype(np.int32))
    return (ss, ts, s_lens, t_lens, dmin), w_eff


def mk_row_batch_of(rng, B, A=4, W=128, L=300):
    """``B`` pairs of :func:`mk_row_batch`'s kind: its five pairs drawn
    again and again, cut to ``B`` (a lone pair is its first: full
    length, the band around the main diagonal)."""
    parts = [mk_row_batch(rng, A=A, W=W, L=L) for _ in range(-(-B // 5))]
    args = [np.concatenate([p[0][i] for p in parts])[:B] for i in range(5)]
    return args, np.concatenate([p[1] for p in parts])[:B]


@pytest.fixture
def rng():
    return np.random.default_rng(0xB15EA7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _assert_results_equal(got, want):
    for a, b in zip(got, want):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("W", [128, 1026, 1536, 2052, 3072, 4096]
                         + CLUSTER_WS)
@pytest.mark.parametrize("flags", FLAG_CASES)
def test_dp_ad_kernel_matches_plain(rng, card, flags, W):
    """Every instance of the kernel: one, two and four lanes per thread,
    with an even and an odd thread count (W 1026 and 2052: a thread's
    lanes alternate parity), above 48 KB of shared memory at W 3072 and
    4096, and the thread-block clusters above 4096 lanes (the whole
    plane held, dead lanes included, so every block edge is); every
    flag set, the main path's local mode on its own instances with and
    without directions, the others on the run-time instance; unit and
    fractional general scores."""
    args, w_eff = mk_batch(rng)
    args = [torch.as_tensor(x, device=card) for x in args]
    args[4] = args[4] + 128 - W          # keep the band around the diagonal
    for subst, go, ge in ((UNIT, -2.0, -1.0), (GENERAL, -3.0, -0.5)):
        kw = dict(W=W, subst=subst, go=go, ge=ge,
                  flags=ModeFlags(**flags),
                  w_eff=torch.as_tensor(w_eff, device=card), r_chunk=16,
                  device=card)
        for with_dirs in (True, False):
            n0 = launches("dp_ad")
            got = dp_ad.banded_dp_ad(*args, with_dirs=with_dirs, **kw)
            assert launches("dp_ad") == n0 + 1
            want = dp_ad.banded_dp_ad_reference(*args, with_dirs=with_dirs,
                                                **kw)
            assert launches("dp_ad") == n0 + 1
            _assert_results_equal(got, want)
        assert float(got.score.max()) > 60


@pytest.mark.parametrize("r_chunk", [6, 16, 128])
@pytest.mark.parametrize("flags", FLAG_CASES[:3])
def test_dp_ad_kernel_odd_pairs_and_chunk_wrap(rng, card, flags, r_chunk):
    """Seven pairs (the last plane row holds one real pair and a pad),
    the drift's chunk index wrapping mid-launch (every 6, 16 or 128 of
    the 342-384 steps), zero and fractional gap extension."""
    B, L, W = 7, 170, 256
    ss = rng.integers(0, 4, (B, L)).astype(np.int8)
    ts = ss.copy()
    m = rng.random((B, L)) < 0.12
    ts[m] = (ts[m] + 1 + rng.integers(0, 3, m.sum())) % 4
    s_lens = np.array([170, 160, 170, 101, 170, 3, 170], np.int32)
    t_lens = np.array([168, 170, 150, 170, 99, 170, 170], np.int32)
    dmin = np.array([-128, -127, -100, -150, -64, -160, -129], np.int32)
    w_eff = np.array([255, 200, 190, 255, 128, 255, 254], np.int32)
    args = [torch.as_tensor(x, device=card)
            for x in (ss, ts, s_lens, t_lens, dmin)]
    for subst, go, ge in ((GENERAL, -3.0, -0.5), (UNIT, -2.0, 0.0)):
        kw = dict(W=W, subst=subst, go=go, ge=ge, flags=ModeFlags(**flags),
                  w_eff=torch.as_tensor(w_eff, device=card),
                  r_chunk=r_chunk, device=card)
        for with_dirs in (True, False):
            n0 = launches("dp_ad")
            got = dp_ad.banded_dp_ad(*args, with_dirs=with_dirs, **kw)
            assert launches("dp_ad") == n0 + 1
            want = dp_ad.banded_dp_ad_reference(*args, with_dirs=with_dirs,
                                                **kw)
            _assert_results_equal(got, want)
        assert got.score.shape == (B,) and float(got.score.max()) > 100


@pytest.mark.parametrize("W", CLUSTER_WS)
@pytest.mark.parametrize("flags", FLAG_CASES[:3])
def test_dp_ad_cluster_edges_match_plain(rng, card, flags, W):
    """Above 4096 lanes: pairs whose alignments run along the lanes at
    which the cluster's blocks meet (and along the band's two edges),
    every lane live, so the neighbour exchange over distributed shared
    memory carries live values; with and without directions."""
    blocks, lpt, clusters = dp_ad.cluster(W, device=card)
    assert blocks > 1 and lpt in (2, 4) and clusters > 0
    assert W % blocks == 0 and (W // blocks) % (2 * lpt) == 0
    lanes = cluster_edges(W, W // blocks)
    ss, ts, s_lens, t_lens = mk_edge_batch(rng, lanes)
    dmin = -np.array(lanes, np.int32)       # diagonal 0 on its lane
    args = [torch.as_tensor(x, device=card)
            for x in (ss, ts, s_lens, t_lens, dmin)]
    for subst, go, ge in ((UNIT, -2.0, -1.0), (GENERAL, -3.0, -0.5)):
        kw = dict(W=W, subst=subst, go=go, ge=ge, flags=ModeFlags(**flags),
                  r_chunk=16, device=card)
        for with_dirs in (True, False):
            n0 = launches("dp_ad")
            got = dp_ad.banded_dp_ad(*args, with_dirs=with_dirs, **kw)
            assert launches("dp_ad") == n0 + 1
            _assert_results_equal(got, dp_ad.banded_dp_ad_reference(
                *args, with_dirs=with_dirs, **kw))
    if flags.get("local_start"):
        assert float(got.score.min()) > 60


def test_kernels_take_a_40_letter_alphabet(rng, card):
    """K1 and K4 with a random 40 x 40 matrix (fractional mismatches),
    at one block and as a cluster, against their twins."""
    A = 40
    subst = random_subst(rng, A)
    for W in (256, 8192):
        lanes = [W // 2 - 1, W // 2, 7, W - 9]
        ss, ts, s_lens, t_lens = mk_edge_batch(rng, lanes, A=A)
        for flags in FLAG_CASES[:3]:
            for with_dirs in (True, False):
                kw = dict(W=W, subst=subst, go=-3.0, ge=-0.5,
                          flags=ModeFlags(**flags), with_dirs=with_dirs,
                          device=card)
                ad = [torch.as_tensor(x, device=card) for x in
                      (ss, ts, s_lens, t_lens, -np.array(lanes, np.int32))]
                _assert_results_equal(
                    dp_ad.banded_dp_ad(*ad, r_chunk=16, **kw),
                    dp_ad.banded_dp_ad_reference(*ad, r_chunk=16, **kw))
                row = [torch.as_tensor(x, device=card) for x in
                       (ss, ts, s_lens, t_lens,
                        np.array(lanes, np.int32) - W + 1)]
                got = dp_row.banded_dp_row(*row, **kw)
                _assert_results_equal(
                    got, dp_row.banded_dp_row_reference(*row, **kw))
        assert float(got.score.max()) > 100


def test_walk_kernel_over_a_cluster_plane(rng, card):
    """The walk over K1's W 8192 plane (alignments along the lanes at
    which the blocks meet) against its twin: trace bytes and cursors."""
    W = 8192
    blocks = dp_ad.cluster(W, device=card)[0]
    lanes = cluster_edges(W, W // blocks)
    ss, ts, s_lens, t_lens = mk_edge_batch(rng, lanes)
    dmin = -np.array(lanes, np.int32)
    args = [torch.as_tensor(x, device=card)
            for x in (ss, ts, s_lens, t_lens, dmin)]
    res = dp_ad.banded_dp_ad(*args, W=W, subst=UNIT, go=-2.0, ge=-1.0,
                             flags=ModeFlags(local_start=True,
                                             local_end=True),
                             with_dirs=True, device=card)
    dminq = dp_ad.parity_adjusted_dmin(
        args[4], torch.arange(len(lanes), device=card) % 2)
    n0 = launches("walk")
    got = walk.traceback_walk(res.dirs, dminq, res.end_i, res.end_j, W=W,
                              device=card)
    assert launches("walk") == n0 + 1
    want = walk.traceback_walk_reference(res.dirs, dminq, res.end_i,
                                         res.end_j, W=W, device=card)
    _assert_results_equal(got, want)
    moves = walk.trace_moves(got[0], len(lanes))
    assert torch.equal(moves[0], res.end_i - got[1])
    assert int(moves[0].min()) > 100


@pytest.mark.parametrize("flags", FLAG_CASES[:3])
def test_plain_twins_replayed_from_graphs_match_their_loop(rng, card,
                                                           monkeypatch,
                                                           flags):
    """On the card the twins replay chunks of steps from a CUDA graph
    (steps.run_steps): the DP twin's and the walk twin's outputs equal
    their step-by-step loop's, with a tail of steps after the last whole
    chunk (306 steps: 128 as written, 128 replayed, 50 as written)."""
    args, w_eff = mk_batch(rng)
    args = [torch.as_tensor(x, device=card) for x in args]
    kw = dict(W=128, subst=GENERAL, go=-3.0, ge=-0.5,
              flags=ModeFlags(**flags),
              w_eff=torch.as_tensor(w_eff, device=card), r_chunk=6,
              with_dirs=True, device=card)
    dminq = dp_ad.parity_adjusted_dmin(args[4], torch.arange(
        len(args[4]), device=card, dtype=torch.int32) % 2)

    def twins():
        res = dp_ad.banded_dp_ad_reference(*args, **kw)
        assert res.dirs.shape[0] * 2 == 306
        return res, walk.traceback_walk_reference(
            res.dirs, dminq, res.end_i, res.end_j, W=128, device=card)

    graphed, graphed_walk = twins()
    monkeypatch.setattr(steps, "GRAPH_CHUNK", 1 << 30)
    looped, looped_walk = twins()
    _assert_results_equal(graphed, looped)
    _assert_results_equal(graphed_walk, looped_walk)
    assert graphed_walk[0].any()


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_row_engine_replayed_from_graphs_matches_its_loop(rng, card,
                                                          monkeypatch, flags):
    """On the card the row engine (``ops/banded_dp``, the row route's and
    ``Aligner(backend="lax")``'s) replays chunks of rows from a CUDA
    graph: scores, end cells and the whole plane equal its row-by-row
    loop's and the CPU's, banded and full, with a tail after the last
    whole chunk (300 rows: 128 as written, 128 replayed, 44 as
    written)."""
    from biseqt_tpu_torch.ops.banded_dp import banded_dp, full_dp

    args, w_eff = mk_row_batch(rng)
    kw = dict(subst=GENERAL, go=-3.0, ge=-0.5, flags=ModeFlags(**flags),
              with_dirs=True)

    def both(device):
        on = [torch.as_tensor(x, device=device) for x in args]
        return (banded_dp(*on, W=128, w_eff=torch.as_tensor(
                    w_eff, device=device), device=device, **kw),
                full_dp(*on[:4], device=device, **kw))

    graphed = both(card)
    cpu = both("cpu")
    monkeypatch.setattr(steps, "GRAPH_CHUNK", 1 << 30)
    looped = both(card)
    for g, lp, c in zip(graphed, looped, cpu):
        assert g.dirs.shape[1] == 300
        _assert_results_equal(g, lp)
        _assert_results_equal([x.cpu() for x in g], c)


def _walk_plane(rng, kind, B2, Rp, W):
    """A walk's inputs ``(dirs, dminq, end_i, end_j)``.  ``random``:
    every source and gap bit pattern, so walks are short.  ``deep``:
    nibbles that never stop, so every walk runs until i or j is 0 and
    crosses many plane windows.  ``runs``: the same with four cells in
    five diagonal, so the kernel takes long diagonal runs in one pass.
    ``edges``: as ``deep``, with walkers that
    start on lane 0 or lane W - 1.  ``gaps``: runs of insertions (or
    deletions) longer than a window, so the gap state crosses window
    boundaries, and walkers that leave the band.  Every kind has skipped
    pairs (-1) and end cells beyond the plane (A >= 2 Rp)."""
    B = 2 * B2 - 1
    if kind == "random":
        dirs = rng.integers(0, 256, (Rp, B2, W)).astype(np.uint8)
    elif kind == "gaps":
        # E-source + E-extend nibbles in some pairs' columns, F-source +
        # F-extend in the others (runs to lane W - 1 or to lane 0), with
        # a diagonal nibble now and then
        run = rng.choice(np.array([0x66, 0xBB], np.uint8), (1, B2, 1))
        diag = rng.random((Rp, B2, W)) < 0.01
        dirs = np.where(diag, np.uint8(0x11), run).astype(np.uint8)
    else:
        src = rng.integers(1, 4, (2, Rp, B2, W))
        bits = rng.integers(0, 4, (2, Rp, B2, W)) * 4
        nib = src + bits * (rng.random((2, Rp, B2, W)) < 0.3)
        dirs = (nib[0] + 16 * nib[1]).astype(np.uint8)
        if kind == "runs":
            diag = rng.random((Rp, B2, W)) < 0.8
            dirs = np.where(diag, np.uint8(0x11), dirs).astype(np.uint8)
    if kind == "random":
        dminq = rng.integers(-W + 1, 1, B).astype(np.int32)
        ei = rng.integers(1, Rp, B).astype(np.int32)
        ej = np.clip(ei - dminq - rng.integers(0, W, B), 0, Rp - 1
                     ).astype(np.int32)
    else:
        # start lane x, and the band start of the walker's parity
        ei = rng.integers(Rp // 2, Rp, B).astype(np.int32)
        ej = rng.integers(Rp // 2, Rp, B).astype(np.int32)
        x = rng.integers(0, W, B)
        if kind == "edges":
            x = np.where(np.arange(B) % 2, W - 1, 0)
        ej -= (ei - ej - x - np.arange(B)) % 2
        dminq = (ei - ej - x).astype(np.int32)
    ei[::7] = -1
    ei[3::11], ej[3::11] = Rp, Rp           # A = 2 Rp: never acts
    return dirs, dminq, ei, ej


@pytest.mark.parametrize("kind,B2,Rp,W", [
    ("random", 130, 16, 256), ("random", 20, 40, 128),
    ("deep", 8, 640, 4096), ("deep", 40, 601, 128), ("runs", 16, 700, 256),
    ("edges", 16, 333, 256), ("gaps", 12, 400, 512)])
def test_walk_kernel_matches_plain(rng, card, kind, B2, Rp, W):
    """The kernel against its twin, trace bytes and cursors: random
    planes, walks across many plane windows at W 4096, long diagonal
    runs, walkers on the band's edge lanes, gap runs across window
    boundaries, odd Rp, skipped pairs and end cells beyond the plane."""
    on = [torch.as_tensor(x, device=card)
          for x in _walk_plane(rng, kind, B2, Rp, W)]
    n0 = launches("walk")
    got = walk.traceback_walk(*on, W=W, device=card)
    assert launches("walk") == n0 + 1
    want = walk.traceback_walk_reference(*on, W=W, device=card)
    _assert_results_equal(got, want)
    assert got[0].any()
    if kind in ("deep", "runs", "gaps"):
        di, dj = walk.trace_moves(got[0], len(on[0]))
        assert int((di + dj).max()) > 2 * walk.DEPTH   # crosses windows


def random_traces(rng, B2, B, rows, dense):
    """Random op bytes (``dense``: share of nonzero bytes), the last byte
    row of every column full so that each replay ends at the plane's last
    antidiagonal, cursors near the origin, -1 skips, and lengths that
    hold every replay: ``(trace, fin_i, fin_j, s_codes, t_codes, s_lens,
    t_lens)`` as numpy, the C++ compactor's and the compaction op's
    inputs."""
    tr = rng.integers(0, 256, (2, rows, B2)).astype(np.uint8)
    tr[rng.random(tr.shape) >= dense] = 0
    tr[:, -1, :] = rng.integers(0, 4, (2, B2)) * 0x55 | 0x40
    L = 4 * rows + 40
    ss = rng.integers(0, 4, (B, L)).astype(np.int8)
    ts = rng.integers(0, 4, (B, L + 3)).astype(np.int8)
    fi = rng.integers(0, 2 * rows, B).astype(np.int32)
    fj = rng.integers(0, 2 * rows, B).astype(np.int32)
    fi[4::5] = -1
    fj[3::7] = -1
    s_lens = rng.integers(L - 10, L + 1, B).astype(np.int32)
    t_lens = rng.integers(L - 10, L + 4, B).astype(np.int32)
    return tr, fi, fj, ss, ts, s_lens, t_lens


def _homologous_launch(rng, B, L, LS, W):
    """A launch's inputs of ``B`` homologous pairs about ``L`` letters
    long (10% substitutions, a 5-letter deletion and a 4-letter insertion
    in T), padded to ``LS`` letters, the band ``W`` lanes wide around the
    main diagonal: ``(s_codes, t_codes, s_lens, t_lens, dmin)``."""
    ss = np.zeros((B, LS), np.int8)
    ts = np.zeros((B, LS), np.int8)
    s_lens = rng.integers(L - L // 10, L + 1, B).astype(np.int32)
    t_lens = np.zeros(B, np.int32)
    for b, n in enumerate(s_lens):
        s = rng.integers(0, 4, n)
        t = s.copy()
        hit = rng.random(n) < 0.1
        t[hit] = (t[hit] + 1 + rng.integers(0, 3, hit.sum())) % 4
        t = np.concatenate([t[:n // 3], t[n // 3 + 5: 2 * n // 3],
                            rng.integers(0, 4, 4), t[2 * n // 3:]])
        ss[b, :n] = s
        ts[b, :len(t)] = t
        t_lens[b] = len(t)
    dmin = np.full(B, -(W // 2), np.int32)
    return ss, ts, s_lens, t_lens, dmin


def _assert_compactions_equal(got, want):
    """The kernel's and the twin's outputs: lengths and moves equal, and
    each row's bytes up to its length (the kernel leaves the rest)."""
    ops, ops_len, di, dj = got
    assert torch.equal(ops_len, want[1])
    assert torch.equal(di, want[2]) and torch.equal(dj, want[3])
    held = (torch.arange(ops.shape[1], device=ops.device)
            < ops_len[:, None])
    assert torch.equal(ops[held], want[0][held])


@pytest.mark.parametrize("B,L,LS,W,flags", [
    (2048, 10_500, 12288, 256, FLAG_CASES[0]),
    (2048, 10_500, 12288, 256, FLAG_CASES[1]),
    (3, 160_000, 196_608, 1024, FLAG_CASES[0])])
def test_compact_kernel_matches_twin_and_cpp(rng, card, B, L, LS, W, flags):
    """The compaction of real walks' traces at the batched extension's
    shape (2048 pairs of ~10 kbp, W 256, local and global) and at a
    genome window's (3 rows of ~384 k antidiagonals, W 1024): the kernel
    equals its twin on the card (lengths, moves, bytes) and, decoded,
    the C++ compactor (transcripts and start cells)."""
    ss, ts, s_lens, t_lens, dmin = _homologous_launch(rng, B, L, LS, W)
    f = ModeFlags(**flags)
    res, codes = dp_ad.banded_dp_ad(
        ss, ts, s_lens, t_lens, dmin, W=W, subst=UNIT, go=-3.0, ge=-1.0,
        flags=f, with_dirs=True, device=card, return_codes=True)
    dminq = dp_ad.parity_adjusted_dmin(dmin, np.arange(B, dtype=np.int32)
                                       % 2)
    trace, fi, fj = walk.traceback_walk(res.dirs, dminq, res.end_i,
                                        res.end_j, W=W, device=card)
    assert 4 * trace.shape[1] >= 2 * L
    n0 = launches("compact")
    got = compact.compact(trace, fi, fj, *codes, f)
    assert launches("compact") == n0 + 1
    want = compact.compact_reference(trace, fi, fj, *codes, f)
    _assert_compactions_equal(got, want)
    moves = walk.trace_moves(trace, B)
    assert torch.equal(got[2], moves[0]) and torch.equal(got[3], moves[1])
    host = [x.cpu().numpy() for x in got]
    tr, fi, fj = (x.cpu().numpy() for x in (trace, fi, fj))
    ops = compact.transcripts(host[0], host[1], fi, fj, host[2:], s_lens,
                              t_lens, f)
    cpp = native.compact_sweep_ops_t(tr, fi, fj, ss, ts, s_lens, t_lens, f)
    assert ops[0] == cpp[0]
    np.testing.assert_array_equal(ops[1], cpp[1])
    np.testing.assert_array_equal(ops[2], cpp[2])
    assert min(map(len, ops[0])) > L * 0.8


@pytest.mark.parametrize("B2,B,rows,dense", [
    (1, 1, 1, 1.0), (4, 7, 9, 0.5), (13, 25, 40, 0.9), (6, 12, 3, 0.2),
    (3, 5, 8192, 0.7), (2, 3, 40_000, 0.3), (40, 79, 1500, 0.05)])
@pytest.mark.parametrize("flags", FLAG_CASES[:3])
def test_compact_kernel_on_random_traces(rng, card, flags, B2, B, rows,
                                         dense):
    """Random op bytes at block sizes from one warp to 1024 threads (one
    round to 40), replays that end at the plane's last antidiagonal and
    skipped pairs: kernel == twin == the C++ compactor."""
    tr, fi, fj, ss, ts, s_lens, t_lens = random_traces(rng, B2, B, rows,
                                                       dense)
    on = [torch.as_tensor(x, device=card)
          for x in (tr, fi, fj, ss, ts, s_lens, t_lens)]
    f = ModeFlags(**flags)
    got = compact.compact(*on, f)
    _assert_compactions_equal(got, compact.compact_reference(*on, f))
    host = [x.cpu().numpy() for x in got]
    ops = compact.transcripts(host[0], host[1], fi, fj, host[2:], s_lens,
                              t_lens, f)
    cpp = native.compact_sweep_ops_t(tr, fi, fj, ss, ts, s_lens, t_lens, f)
    assert ops[0] == cpp[0]
    np.testing.assert_array_equal(ops[1], cpp[1])
    np.testing.assert_array_equal(ops[2], cpp[2])


def test_compact_kernel_is_bad_row_safe(rng, card):
    """Cursors outside their pair's matrix and replays that would leave
    it (a pair whose lengths are cut below its moves) get length -1 on
    the card; the other rows are the twin's, and the host raises as the
    C++ binding does."""
    tr, fi, fj, ss, ts, s_lens, t_lens = random_traces(rng, 8, 16, 64, 0.8)
    f = ModeFlags(local_start=True)
    good = native.compact_sweep_ops_t(tr, fi, fj, ss, ts, s_lens, t_lens, f)
    fi[1], fj[2], fi[6] = s_lens[1] + 1, 2 ** 31 - 1, 10 ** 6
    t_lens[3] = 2
    fi[3], fj[3] = 0, 0
    on = [torch.as_tensor(x, device=card)
          for x in (tr, fi, fj, ss, ts, s_lens, t_lens)]
    got = compact.compact(*on, f)
    _assert_compactions_equal(got, compact.compact_reference(*on, f))
    ops_len = got[1].cpu().numpy()
    assert ops_len[[1, 2, 3, 6]].tolist() == [-1] * 4
    ops = got[0].cpu().numpy()
    for b in set(range(16)) - {1, 2, 3, 6}:
        assert ops[b, :ops_len[b]].tobytes().decode() == good[0][b]
    host = [x.cpu().numpy() for x in got]
    with pytest.raises(ValueError, match="outside their pair"):
        compact.transcripts(host[0], host[1], fi, fj, host[2:], s_lens,
                            t_lens, f)


def test_extend_segments_card_matches_cpu(rng, card):
    """The whole slice on the card equals the plain twins on the CPU:
    scores, transcripts, start cells and source indices."""
    A4 = Alphabet("ACGT")
    blocks, s_parts, t_parts, segments = 3, [], [], []
    s_pos = t_pos = 0
    for k in range(blocks):
        core = rng.integers(0, 4, 300)
        mut = core.copy()
        hit = rng.random(300) < 0.1
        mut[hit] = (mut[hit] + 1 + rng.integers(0, 3, hit.sum())) % 4
        gap_s, gap_t = 200 + 50 * k, 100 + 300 * k
        s_parts += [rng.integers(0, 4, gap_s), core]
        t_parts += [rng.integers(0, 4, gap_t), mut]
        i0, j0 = s_pos + gap_s, t_pos + gap_t
        d, a = i0 - j0, i0 + j0
        segments.append({"segment": ((d - 8, d + 8), (a, a + 600))})
        s_pos, t_pos = i0 + 300, j0 + 300
    S = Sequence(A4, np.concatenate(s_parts))
    T = Sequence(A4, np.concatenate(t_parts))
    kw = dict(go_score=-3.0, ge_score=-1.0, with_transcripts=True,
              _r_chunk=16)
    n_plan = len(extension_plan(segments, len(S), len(T), True)[3])
    n = {k: launches(k) for k in ("dp_ad", "walk", "compact")}
    got = extend_segments(S, T, segments, device=card, **kw)
    assert {k: launches(k) - v for k, v in n.items()} == {
        "dp_ad": n_plan, "walk": n_plan, "compact": n_plan}
    want = extend_segments(S, T, segments, device="cpu", **kw)
    assert got == want
    assert all(seg["score"] > 150 and len(seg["transcript"]) > 250
               for seg in got)
    # the host walk over the card's plane: K1 launched, the walk and
    # compaction kernels not, and the transcripts the device walk's
    n_dp, n_walk = launches("dp_ad"), launches("walk", "compact")
    host = extend_segments(S, T, segments, device=card, use_pallas=True,
                           device_walk=False, **kw)
    assert launches("dp_ad") - n_dp == n_plan
    assert launches("walk", "compact") == n_walk
    assert host == got
    # the row route on the card: the row engine there, no kernel
    # launched, equal to the same route on the CPU
    n0 = launches()
    row = extend_segments(S, T, segments, device=card, use_pallas=False,
                          **kw)
    assert launches() == n0
    assert row == extend_segments(S, T, segments, device="cpu",
                                  use_pallas=False, **kw)
    assert [seg["score"] for seg in row] == [seg["score"] for seg in got]


def _three_launch_plan(rng):
    """Three planted 300 bp blocks whose segments' bands bucket to W 128,
    256 and 384: one launch each."""
    A4 = Alphabet("ACGT")
    s_parts, t_parts, segments = [], [], []
    s_pos = t_pos = 0
    for k, half in enumerate((8, 80, 150)):
        core = rng.integers(0, 4, 300)
        mut = core.copy()
        hit = rng.random(300) < 0.1
        mut[hit] = (mut[hit] + 1 + rng.integers(0, 3, hit.sum())) % 4
        gap_s, gap_t = 200 + 50 * k, 100 + 300 * k
        s_parts += [rng.integers(0, 4, gap_s), core]
        t_parts += [rng.integers(0, 4, gap_t), mut]
        i0, j0 = s_pos + gap_s, t_pos + gap_t
        d, a = i0 - j0, i0 + j0
        segments.append({"segment": ((d - half, d + half), (a, a + 600))})
        s_pos, t_pos = i0 + 300, j0 + 300
    S = Sequence(A4, np.concatenate(s_parts))
    T = Sequence(A4, np.concatenate(t_parts))
    return S, T, segments


def _counted_since(before):
    """The counts made since the ``profiling.counts()`` snapshot
    ``before``, by span."""
    out = {}
    for span, row in profiling.counts().items():
        grew = {k: n - before.get(span, {}).get(k, 0) for k, n in row.items()
                if n != before.get(span, {}).get(k, 0)}
        if grew:
            out[span] = grew
    return out


def test_counts_and_ranges_of_a_call_on_the_card(rng, card, tmp_path):
    """Extension on the card counts K1, the walk and the compaction under
    ``pipeline.launch`` (with the results' copies to pinned memory: the
    scores, the cursors and moves, the transcript bytes) and the inputs'
    copies to the card under ``dp_ad.inputs``; discovery
    counts its copies to pageable memory under ``seeds.fetch``,
    ``blot.grid`` and ``blot.stats``; under a profiler the spans are
    ranges beside the card's kernels."""
    S, T, segments = _three_launch_plan(rng)
    kw = dict(go_score=-3.0, ge_score=-1.0, with_transcripts=True,
              _r_chunk=16, device=card)
    extend_segments(S, T, segments, **kw)
    before = profiling.counts()
    extend_segments(S, T, segments, **kw)
    got = _counted_since(before)
    assert set(got) == {"pipeline.launch", "dp_ad.inputs"}
    assert got["pipeline.launch"]["launches.dp_ad"] == 3
    assert got["pipeline.launch"]["launches.walk"] == 3
    assert got["pipeline.launch"]["launches.compact"] == 3
    assert set(got["pipeline.launch"]) == {
        "launches.dp_ad", "launches.walk", "launches.compact",
        "bytes_to_card", "bytes_to_host.pinned"}
    # per launch of n pairs padded to n_pad: the walk's band starts to the
    # card (the compaction reads K1's codes there); back to pinned memory
    # the scores, six int32 a pair (cursors, moves, the walk's check, the
    # transcript's length) and n rows of LS + LT + 2 transcript bytes
    plan = extension_plan(segments, len(S), len(T), True)[3]
    pads = [pipeline._bucket(len(idxs), mini=2) for idxs, *_ in plan]
    assert got["pipeline.launch"]["bytes_to_card"] == 4 * sum(pads)
    assert got["pipeline.launch"]["bytes_to_host.pinned"] == sum(
        len(idxs) * (4 + LS + LT + 2) + 24 * n_pad
        for (idxs, LS, LT, _), n_pad in zip(plan, pads))
    assert set(got["dp_ad.inputs"]) == {"bytes_to_card"}
    codes = sum(len(S) + len(T) for _ in range(3))
    assert got["dp_ad.inputs"]["bytes_to_card"] > codes // 4

    G, H = _planted_genome_pair(rng, size=60_000, blocks=3, block=5000)
    before = profiling.counts()
    wb = blot.WordBlot(G, H, wordlen=12, g_max=0.1, device=card)
    segs = list(wb.similar_segments(K_min=1500, p_min=0.6))
    got = _counted_since(before)
    assert len(segs) >= 3
    assert got["seeds.fetch"] == {
        "bytes_to_host.pageable": 2 * 8 * len(wb.seed_index)}
    assert got["blot.grid"]["bytes_to_host.pageable"] > 0
    # p-hat, S0 and S1 in float32 for every candidate, kept or not
    stats = got["blot.stats"]["bytes_to_host.pageable"]
    assert stats % 12 == 0 and stats >= 12 * len(segs)

    with profiling.trace(str(tmp_path)):
        extend_segments(S, T, segments, **kw)
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"pipeline.extend", "pipeline.launch", "dp_ad.inputs",
            "pipeline.wait", "pipeline.compact"} <= names
    assert any(e.get("cat") == "kernel" and "dp_ad_kernel" in e["name"]
               for e in events)


@pytest.mark.parametrize("device_walk", [True, False])
def test_extend_segments_in_flight_equals_serial_on_the_card(
        rng, card, monkeypatch, device_walk):
    """Three launches on the card, every one in flight (the default
    budget) and one at a time (budget 0): the same output, equal to the
    plain twins' on the CPU."""
    from biseqt_tpu_torch import pipeline

    S, T, segments = _three_launch_plan(rng)
    kw = dict(go_score=-3.0, ge_score=-1.0, with_transcripts=True,
              device_walk=device_walk, _r_chunk=16)
    assert len(pipeline.extension_plan(segments, len(S), len(T),
                                       True)[3]) == 3
    n_dp, n_walk = launches("dp_ad"), launches("walk")
    in_flight = extend_segments(S, T, segments, device=card, **kw)
    monkeypatch.setattr(pipeline, "PIPELINE_BYTES", 0)
    serial = extend_segments(S, T, segments, device=card, **kw)
    # K1 on each of the 3 launches, twice, and the walk after each on
    # the device walk's route
    assert launches("dp_ad") - n_dp == 6
    assert launches("walk") - n_walk == (6 if device_walk else 0)
    assert in_flight == serial
    assert serial == extend_segments(S, T, segments, device="cpu", **kw)
    assert all(seg["score"] > 150 for seg in serial)


def test_walk_route_dispatch_does_not_wait_for_the_card(rng, card,
                                                       monkeypatch):
    """Each launch of the device walk's route (K1, the walk, its check,
    the compaction and the copies to pinned memory) is queued without
    waiting for the card: CUDA's sync debug mode set to raise around
    each dispatch, three launches in flight, the output the CPU's."""
    S, T, segments = _three_launch_plan(rng)
    kw = dict(go_score=-3.0, ge_score=-1.0, with_transcripts=True,
              _r_chunk=16)
    warm = extend_segments(S, T, segments, device=card, **kw)
    dispatch = pipeline._dispatch
    routes = []

    def without_sync(*args):
        routes.append(args[5])
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(pipeline, "_dispatch", without_sync)
    n0 = launches("compact")
    got = extend_segments(S, T, segments, device=card, **kw)
    assert routes == ["walk"] * 3 and launches("compact") == n0 + 3
    assert got == warm == extend_segments(S, T, segments, device="cpu",
                                          **kw)


def test_extend_segments_row_route_in_flight_on_the_card(rng, card,
                                                         monkeypatch):
    """The row route (``use_pallas=False``) on three launches: no kernel
    launched, each dispatch queued without waiting for the card (CUDA's
    sync debug mode set to raise around it), every launch in flight and
    one at a time the same output, equal to the row route on the CPU."""
    from biseqt_tpu_torch import pipeline

    S, T, segments = _three_launch_plan(rng)
    kw = dict(go_score=-3.0, ge_score=-1.0, with_transcripts=True,
              use_pallas=False)
    assert len(pipeline.extension_plan(segments, len(S), len(T), True,
                                       row=True)[3]) == 3
    dispatch = pipeline._dispatch

    def without_sync(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(pipeline, "_dispatch", without_sync)
    n0 = launches()
    in_flight = extend_segments(S, T, segments, device=card, **kw)
    monkeypatch.setattr(pipeline, "PIPELINE_BYTES", 0)
    serial = extend_segments(S, T, segments, device=card, **kw)
    assert launches() == n0
    assert in_flight == serial
    assert serial == extend_segments(S, T, segments, device="cpu", **kw)
    assert all(seg["score"] > 150 for seg in serial)


def test_extend_segments_bad_walk_raises_on_the_card(rng, card, monkeypatch):
    """The second of three launches in flight walks a trace corrupted on
    the card (one diagonal op turned into an insertion): its finish
    raises."""
    from biseqt_tpu_torch import pipeline

    S, T, segments = _three_launch_plan(rng)
    walks = []
    real = pipeline.traceback_walk

    def corrupt(*args, **kwargs):
        trace, fi, fj = real(*args, **kwargs)
        walks.append(1)
        if len(walks) == 2:
            trace = trace.clone()
            row = int(torch.nonzero(trace[0, :, 0] & 3 == 1)[0, 0])
            trace[0, row, 0] += 1
        return trace, fi, fj

    monkeypatch.setattr(pipeline, "traceback_walk", corrupt)
    with pytest.raises(RuntimeError, match="does not lead from the end"):
        extend_segments(S, T, segments, device=card, go_score=-3.0,
                        ge_score=-1.0, with_transcripts=True, _r_chunk=16)
    assert len(walks) == 3


@pytest.mark.parametrize("W,B", [
    (128, 1), (128, 5), (128, 600), (256, 1), (256, 5), (256, 600),
    (384, 1), (512, 1), (512, 5), (512, 600), (1280, 5), (2176, 5),
    (2560, 5), (4096, 1), (4096, 5)] + [(W, 5) for W in CLUSTER_WS])
@pytest.mark.parametrize("A", [4, 20])
@pytest.mark.parametrize("flags", FLAG_CASES)
def test_dp_row_kernel_matches_plain(rng, card, flags, A, W, B):
    """K4 against its twin, score-only and with directions, in the
    geometries the planner picks for the batch: a lone pair, a handful
    and 600 pairs (a warp per pair at W 128 and 256; from W 384 a block
    per pair of 4 or 8 lanes a thread, its last warp's lanes past W dead
    at W 384 and 2176; above 4096 a cluster of blocks per pair); every
    flag set of pw._FLAGS, a 4- and a 20-letter alphabet."""
    args, w_eff = mk_row_batch_of(rng, B, A=A, W=W)
    args = [torch.as_tensor(x, device=card) for x in args]
    if A == 4:
        subst, go, ge = UNIT, -2.5, -1.0
    else:
        subst, go, ge = BLOSUM62, -11.0, -0.5
    kw = dict(W=W, subst=subst, go=go, ge=ge, flags=ModeFlags(**flags),
              w_eff=torch.as_tensor(w_eff, device=card), device=card)
    for with_dirs in (False, True):
        n0 = launches("dp_row")
        got = dp_row.banded_dp_row(*args, with_dirs=with_dirs, **kw)
        assert launches("dp_row") == n0 + 1
        want = dp_row.banded_dp_row_reference(*args, with_dirs=with_dirs,
                                              **kw)
        assert launches("dp_row") == n0 + 1
        _assert_results_equal(got, want)
    assert float(got.score.max()) > 100


@pytest.mark.parametrize("W", [128, 256])
@pytest.mark.parametrize("B", [7, 3200])
def test_dp_row_kernel_ragged_batch(rng, card, W, B):
    """Pairs of very different lengths (1 to 2000 rows, T from 1 to 2100)
    side by side, a warp each: 7 pairs (fewer than SMs) and 3200, every
    flag set of pw._FLAGS, with and without directions."""
    L = 2000
    ss = rng.integers(0, 4, (B, L)).astype(np.int8)
    ts = np.concatenate([ss, rng.integers(0, 4, (B, 100)).astype(np.int8)],
                        axis=1)
    m = rng.random(ts.shape) < 0.12
    ts[m] = (ts[m] + 1) % 4
    s_lens = rng.integers(1, L + 1, B).astype(np.int32)
    s_lens[:3] = (1, L, 37)
    t_lens = np.clip(s_lens + rng.integers(-60, 100, B), 1, L + 100
                     ).astype(np.int32)
    dmin = rng.integers(-W + 8, -8, B).astype(np.int32)
    w_eff = rng.integers(W // 2, W + 1, B).astype(np.int32)
    args = [torch.as_tensor(x, device=card)
            for x in (ss, ts, s_lens, t_lens, dmin)]
    for flags in FLAG_CASES:
        for with_dirs in (False, True):
            kw = dict(W=W, subst=UNIT, go=-2.0, ge=-1.0,
                      flags=ModeFlags(**flags), with_dirs=with_dirs,
                      w_eff=torch.as_tensor(w_eff, device=card), device=card)
            got = dp_row.banded_dp_row(*args, **kw)
            _assert_results_equal(got, dp_row.banded_dp_row_reference(
                *args, **kw))
    assert dp_row.plan(B, W, sms=dp_row.sm_count(card)) == dp_row.Geometry(
        W // 32, True)


@pytest.mark.parametrize("W", CLUSTER_WS)
@pytest.mark.parametrize("flags", ROW_FLAGS[:3])
def test_dp_row_cluster_edges_match_plain(rng, card, flags, W):
    """Above 4096 lanes: pairs whose alignments run along the lanes at
    which the cluster's blocks meet (and the band's two edges), every
    lane live, so the E scan's carry, the up neighbour and the end
    cell's reduction cross blocks; with and without directions."""
    geo = dp_row.plan(5, W, sms=dp_row.sm_count(card))
    assert geo.cluster > 1 and dp_row.clusters(W, device=card) > 0
    lanes = cluster_edges(W, geo.threads(W) * geo.lpt)
    ss, ts, s_lens, t_lens = mk_edge_batch(rng, lanes)
    dmin = np.array(lanes, np.int32) - W + 1     # diagonal 0 on its lane
    args = [torch.as_tensor(x, device=card)
            for x in (ss, ts, s_lens, t_lens, dmin)]
    for subst, go, ge in ((UNIT, -2.0, -1.0), (GENERAL, -3.0, -0.5)):
        kw = dict(W=W, subst=subst, go=go, ge=ge, flags=ModeFlags(**flags),
                  device=card)
        for with_dirs in (False, True):
            n0 = launches("dp_row")
            got = dp_row.banded_dp_row(*args, with_dirs=with_dirs, **kw)
            assert launches("dp_row") == n0 + 1
            _assert_results_equal(got, dp_row.banded_dp_row_reference(
                *args, with_dirs=with_dirs, **kw))
    if flags.get("local_start"):
        assert float(got.score.min()) > 60


def test_dp_row_kernel_ragged_and_negative_dmax(rng, card):
    """A band entirely left of the main diagonal (dmax < 0) over a T
    much longer than S, beside ragged pairs, and a general 4 x 4 matrix
    with fractional gap scores."""
    B, LS, LT, W = 3, 120, 640, 128
    ss = rng.integers(0, 4, (B, LS)).astype(np.int8)
    ts = rng.integers(0, 4, (B, LT)).astype(np.int8)
    ts[:, 300:300 + LS] = ss
    s_lens = np.array([LS, 97, LS], np.int32)
    t_lens = np.array([LT, LT, 500], np.int32)
    dmin = np.array([-420, -420, -360], np.int32)
    w_eff = np.array([W - 1, W, 90], np.int32)
    args = [torch.as_tensor(x, device=card)
            for x in (ss, ts, s_lens, t_lens, dmin)]
    general = np.array(
        [[2, -1, -2, -1], [-1, 2, -1, -2], [-2, -1, 2, -1], [-1, -2, -1, 2]],
        np.float32)
    for flags in ROW_FLAGS:
        for subst, go, ge in ((UNIT, -2.0, -1.0), (general, -3.0, -0.5)):
            kw = dict(W=W, subst=subst, go=go, ge=ge,
                      flags=ModeFlags(**flags), with_dirs=True,
                      w_eff=torch.as_tensor(w_eff, device=card), device=card)
            got = dp_row.banded_dp_row(*args, **kw)
            _assert_results_equal(got, dp_row.banded_dp_row_reference(*args,
                                                                      **kw))
        if flags.get("local_start") and flags.get("local_end"):
            assert float(got.score[0]) > 100    # the planted diagonal


def test_aligner_pallas_row_card_matches_cpu(rng, card):
    """Aligner(backend="pallas_row") on the card equals the same call on
    the CPU (the plain twin): scores, transcripts and start cells, for
    DNA and for a 20-letter protein pair under BLOSUM62."""
    cases = []
    A4 = Alphabet("ACGT")
    core = rng.integers(0, 4, 400)
    mut = core.copy()
    hit = rng.random(400) < 0.1
    mut[hit] = (mut[hit] + 1) % 4
    mut = np.concatenate([mut[:150], mut[153:], rng.integers(0, 4, 5)])
    cases.append((Sequence(A4, core), Sequence(A4, mut), None, -3.0, -1.0))
    P = protein_alphabet()
    prot = rng.integers(0, 20, 300)
    pmut = prot.copy()
    hit = rng.random(300) < 0.15
    pmut[hit] = rng.integers(0, 20, hit.sum())
    cases.append((Sequence(P, prot), Sequence(P, pmut), BLOSUM62, -11.0,
                  -1.0))
    for S, T, subst, go, ge in cases:
        for alntype in pw.BANDED_TYPES:
            kw = dict(alnmode=pw.BANDED_MODE, alntype=alntype,
                      diag_range=(-20, 20), subst_scores=subst,
                      go_score=go, ge_score=ge, backend="pallas_row")
            n0 = launches("dp_row")
            with pw.Aligner(S, T, device=card, **kw) as aln:
                got = (aln.solve(), aln.traceback())
            assert launches("dp_row") == n0 + 2
            with pw.Aligner(S, T, device="cpu", **kw) as aln:
                want = (aln.solve(), aln.traceback())
            assert got[0] == want[0] and got[0] > 100
            assert str(got[1].transcript) == str(want[1].transcript)
            assert (got[1].origin_start, got[1].mutate_start) == \
                (want[1].origin_start, want[1].mutate_start)
            assert got[1].calculate_score(aln.subst_scores, go, ge) == got[0]


def test_kernel_wrappers_refuse_bad_launches(card):
    """Shapes the kernels do not take raise before any launch."""
    x = torch.zeros((2, 8), dtype=torch.int8, device=card)
    lens = torch.full((2,), 8, dtype=torch.int32, device=card)
    kw = dict(subst=UNIT, go=-2.0, ge=-1.0, flags=ModeFlags(), device=card)
    n0 = launches()
    with pytest.raises(ValueError, match="W must be even"):
        dp_ad.banded_dp_ad(x, x, lens, lens, lens * 0, W=4100, **kw)
    with pytest.raises(ValueError, match="MAX_W = %d" % dp_ad.MAX_W):
        dp_ad.banded_dp_ad(x, x, lens, lens, lens * 0,
                           W=dp_ad.MAX_W + 8192, **kw)
    with pytest.raises(ValueError, match="passed with device"):
        dp_ad.banded_dp_ad(x.cpu(), x, lens, lens, lens * 0, W=128, **kw)
    with pytest.raises(ValueError, match="dirs must be uint8"):
        walk.traceback_walk(torch.zeros((4, 1, 128), device=card), lens,
                            lens, lens, W=128, device=card)
    with pytest.raises(ValueError, match="multiple of 16"):
        walk.traceback_walk(torch.zeros((4, 1, 130), dtype=torch.uint8,
                                        device=card), lens, lens, lens,
                            W=130, device=card)
    assert launches() == n0
    n0 = launches()
    with pytest.raises(ValueError, match="multiple of 128"):
        dp_row.banded_dp_row(x, x, lens, lens, lens * 0, W=200, **kw)
    with pytest.raises(ValueError, match="A = 20"):
        dp_row.banded_dp_row(x, x, lens, lens, lens * 0, W=128, A=20, **kw)
    with pytest.raises(ValueError, match="MAX_W = %d" % dp_row.MAX_W):
        dp_row.banded_dp_row(x, x, lens, lens, lens * 0,
                             W=dp_row.MAX_W + 8192, **kw)
    assert launches() == n0
    n0 = launches()
    with pytest.raises(ValueError, match="passed with device"):
        transpose_probe.transpose_minor(torch.zeros((1, 2, 3),
                                                    dtype=torch.uint8),
                                        device=card)
    with pytest.raises(ValueError, match="int16"):
        i16_probe.i16_op("add", x, device=card)
    with pytest.raises(ValueError, match="unknown op"):
        i16_probe.i16_op("mul", x.to(torch.int16), device=card)
    assert launches() == n0


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 40, 72), (2, 128, 128),
                                   (2, 130, 257), (5, 300, 129),
                                   (4, 1000, 36), (1288, 512, 128)])
def test_transpose_kernel_matches_plain(rng, card, shape):
    """Ragged edges, widths that are not a multiple of the tile or of 4
    (the byte path), and the probe's plane, larger than L2."""
    x = torch.as_tensor(rng.integers(0, 256, shape).astype(np.uint8),
                        device=card)
    n0 = launches("transpose_probe")
    got = transpose_probe.transpose_minor(x, device=card)
    assert launches("transpose_probe") == n0 + 1
    want = transpose_probe.transpose_minor_reference(x, device=card)
    assert launches("transpose_probe") == n0 + 1
    assert got.shape == (shape[0], shape[2], shape[1]) and torch.equal(
        got, want)


def test_transpose_kernel_unaligned_base(rng, card):
    """A contiguous plane at an odd byte offset takes the byte path."""
    flat = torch.as_tensor(rng.integers(0, 256, 1 + 3 * 256 * 128)
                           .astype(np.uint8), device=card)
    x = flat[1:].view(3, 256, 128)
    assert x.data_ptr() % 4
    got = transpose_probe.transpose_minor(x, device=card)
    assert torch.equal(got, x.transpose(1, 2).contiguous())


@pytest.mark.parametrize("rows", [256, 1001, 1, 3, 5, 7, 255, 65537,
                                  1 << 20])
@pytest.mark.parametrize("name", i16_probe.OPS)
def test_i16_kernel_matches_plain(rng, card, name, rows):
    """Each op on the probe's input and on random int16 at ragged row
    counts (a warp's tile of 4 rows and a block's of 32 cut at several
    points, and 1,048,576 rows, past the L2 cache), and on inputs whose
    base is 2- or 8-byte but not 16-byte aligned (cloned by the
    wrapper)."""
    host = (i16_probe.probe_input() if rows == 256 else
            rng.integers(-32768, 32768, (rows, 128)).astype(np.int16))
    x = torch.as_tensor(host, device=card)
    n0 = launches("i16_probe")
    got = i16_probe.i16_op(name, x, device=card)
    assert launches("i16_probe") == n0 + 1
    want = i16_probe.i16_op_reference(name, x, device=card)
    assert launches("i16_probe") == n0 + 1
    assert got.dtype == torch.int16 and torch.equal(got, want)
    for shift in (1, 4):
        shifted = torch.cat([x.new_zeros(shift), x.reshape(-1)])[shift:]
        shifted = shifted.view(rows, 128)
        assert shifted.data_ptr() % 16
        assert torch.equal(i16_probe.i16_op(name, shifted, device=card), want)


def test_entry_points_default_to_the_card(rng, card):
    """Called without ``device``, the entry points run on the card."""
    x = torch.as_tensor(rng.integers(0, 256, (2, 64, 128)).astype(np.uint8),
                        device=card)
    n0 = launches("transpose_probe")
    assert torch.equal(transpose_probe.transpose_minor(x),
                       x.transpose(1, 2).contiguous())
    assert launches("transpose_probe") == n0 + 1
    A4 = Alphabet("ACGT")
    S = Sequence(A4, rng.integers(0, 4, 300))
    n_dp, n_row = launches("dp_ad"), launches("dp_row")
    out = extend_segments(S, S, [{"segment": ((-8, 8), (20, 560))}])
    assert launches("dp_ad") == n_dp + 1 and out[0]["score"] == 300.0
    with pw.Aligner(S, S, alnmode=pw.BANDED_MODE, alntype=pw.B_GLOBAL,
                    diag_range=(-10, 10), backend="pallas_row") as aln:
        assert aln.solve() == 300.0
    assert launches("dp_row") == n_row + 1
    n_dp = launches("dp_ad")
    out = discover_and_extend(S, S, K_min=100, with_transcripts=True)
    assert launches("dp_ad") > n_dp and out[0]["score"] == 300.0
    assert blot.WordBlot(S, S).seed_index.device.type == "cuda"


def _planted_genome_pair(rng, size=200_000, blocks=6, block=12_000):
    """Two random sequences of ``size`` letters sharing ``blocks``
    homologous blocks (10% substitutions, a few short indels) at shuffled
    places."""
    S = rng.integers(0, 4, size).astype(np.int8)
    T = rng.integers(0, 4, size).astype(np.int8)
    slots = size // blocks
    for k, dst in enumerate(rng.permutation(blocks)):
        core = S[k * slots + 1000:k * slots + 1000 + block].copy()
        hit = rng.random(block) < 0.1
        core[hit] = (core[hit] + rng.integers(1, 4, hit.sum())) % 4
        for p in np.sort(rng.choice(block - 200, 4, replace=False)):
            n = int(rng.integers(1, 4))
            core = (np.concatenate([core[:p], core[p + n:]]) if p % 2
                    else np.concatenate([core[:p], rng.integers(
                        0, 4, n).astype(np.int8), core[p:]]))
        start = dst * slots + 500
        T[start:start + len(core)] = core[:slots - 500]
    A4 = Alphabet("ACGT")
    return Sequence(A4, S), Sequence(A4, T)


@pytest.mark.parametrize("assembler", ["dense", "sparse"])
def test_discovery_card_matches_cpu(rng, card, monkeypatch, assembler):
    """Word-Blot discovery on the card equals discovery on the CPU at a
    200 kbp planted pair: the seed arrays, the grid and its 3x3 sums,
    the candidate components, and the segments with their seed counts
    and order exactly; p-hat and (S0, S1) within rtol 1e-5, atol 1e-6."""
    S, T = _planted_genome_pair(rng)
    if assembler == "sparse":
        monkeypatch.setattr(blot.WordBlot, "MAX_GRID_CELLS", 1)
    kw = dict(wordlen=12, g_max=0.1)
    on_card = blot.WordBlot(S, T, device=card, **kw)
    on_cpu = blot.WordBlot(S, T, device="cpu", **kw)
    for got, want in zip(on_card.seed_index.seed_arrays(),
                         on_cpu.seed_index.seed_arrays()):
        assert np.array_equal(got, want)
    assert len(on_card.seed_index) > 6 * 2000
    K_min, p_min = 4000, 0.6
    for got, want in zip(on_card._grids(K_min), on_cpu._grids(K_min)):
        assert np.array_equal(got, want)
    assert on_card._collect_components(K_min, p_min) == \
        on_cpu._collect_components(K_min, p_min)
    got = list(on_card.similar_segments(K_min=K_min, p_min=p_min))
    want = list(on_cpu.similar_segments(K_min=K_min, p_min=p_min))
    assert len(want) >= 6
    assert [(s["segment"], s["num_seeds"]) for s in got] == \
        [(s["segment"], s["num_seeds"]) for s in want]
    np.testing.assert_allclose([(s["p"], *s["score"]) for s in got],
                               [(s["p"], *s["score"]) for s in want],
                               rtol=1e-5, atol=1e-6)


def test_discover_and_extend_on_the_card(rng, card):
    """The one-call path on the card: both kernels launched, every
    transcript rescores to its score, and the scores equal extension of
    the same segments by the plain twins on the CPU."""
    S, T = _planted_genome_pair(rng, size=60_000, blocks=3, block=5000)
    kw = dict(wordlen=12, g_max=0.1, K_min=1500, p_min=0.6)
    n_dp, n_walk = launches("dp_ad"), launches("walk")
    dispatched = profiling.counters().get("pipeline.launch", {}).get(
        "calls", 0)
    got = discover_and_extend(S, T, with_transcripts=True, device=card, **kw)
    # K1 and the walk on each launch dispatched
    n_dispatch = profiling.counters()["pipeline.launch"]["calls"] - dispatched
    assert n_dispatch and launches("dp_ad") - n_dp == n_dispatch
    assert launches("walk") - n_walk == n_dispatch
    assert len(got) >= 3 and got == sorted(got, key=lambda s: -s["score"])
    for seg in got:
        aln = pw.Alignment(S, T, seg["transcript"],
                           origin_start=seg["origin_start"],
                           mutate_start=seg["mutate_start"])
        assert aln.calculate_score(UNIT, -3.0, -1.0) == seg["score"]
    segments = list(blot.WordBlot(S, T, wordlen=12, g_max=0.1, device="cpu")
                    .similar_segments(K_min=1500, p_min=0.6))
    want = extend_segments(S, T, segments, device="cpu")
    assert sorted(s["score"] for s in got) == sorted(s["score"] for s in want)


def _mutated(rng, seq, n):
    """``n`` letters of ``seq`` from a random locus through the port's
    mutation process (10% errors), and the locus."""
    from biseqt_tpu_torch.stochastics import MutationProcess

    r0 = int(rng.integers(0, len(seq) - n))
    M = MutationProcess(seq.alphabet, subst_probs=0.06, go_prob=0.02,
                        ge_prob=0.05, rng=rng)
    return M.mutate(seq[r0:r0 + n])[0], r0


def test_local_ref_card_matches_cpu(rng, card):
    """Reads mapped against a 200 kbp reference: the reference's table,
    the batch (equal to the serial API) and its segments on the card
    equal the CPU's; p-hat and (S0, S1) within rtol 1e-5, atol 1e-6."""
    A4 = Alphabet("ACGT")
    ref = Sequence(A4, rng.integers(0, 4, 200_000))
    queries, loci = zip(*[_mutated(rng, ref, 5000) for _ in range(10)])
    kw = dict(wordlen=12, g_max=0.25)
    on_card = blot.WordBlotLocalRef(ref, device=card, **kw)
    on_cpu = blot.WordBlotLocalRef(ref, device="cpu", **kw)
    assert np.array_equal(on_card._ref_keys, on_cpu._ref_keys)
    assert np.array_equal(on_card._ref_pos, on_cpu._ref_pos)
    got = on_card.similar_segments_batch(queries, K_min=1000, p_min=0.5)
    want = on_cpu.similar_segments_batch(queries, K_min=1000, p_min=0.5)
    assert got == [list(on_card.similar_segments(q, K_min=1000, p_min=0.5))
                   for q in queries]
    for g, w, r0 in zip(got, want, loci):
        assert [(s["segment"], s["num_seeds"]) for s in g] == \
            [(s["segment"], s["num_seeds"]) for s in w]
        if w:
            np.testing.assert_allclose([(s["p"], *s["score"]) for s in g],
                                       [(s["p"], *s["score"]) for s in w],
                                       rtol=1e-5, atol=1e-6)
        top = max(g, key=lambda s: s["num_seeds"])
        assert top["segment"][0][0] - 200 <= -r0 <= top["segment"][0][1] + 200


def test_map_reads_card_matches_cpu(rng, card):
    """Reads mapped to a 200 kbp reference on the card equal the CPU's:
    segments (p-hat and (S0, S1) within rtol 1e-5, atol 1e-6), the best
    choice and every row.  K1 and the walk are launched once for each
    launch of the joint plan of the best segments."""
    A4 = Alphabet("ACGT")
    ref = Sequence(A4, rng.integers(0, 4, 200_000))
    reads = [_mutated(rng, ref, 2000)[0] for _ in range(8)]
    kw = dict(K_min=500, p_min=0.5, go_score=-3.0, ge_score=-1.0,
              with_transcripts=True)
    on_card = blot.WordBlotLocalRef(ref, wordlen=12, g_max=0.25, device=card)
    on_cpu = blot.WordBlotLocalRef(ref, wordlen=12, g_max=0.25, device="cpu")
    n = {k: launches(k) for k in ("dp_ad", "walk")}
    got = pipeline.map_reads(on_card, reads, device=card, **kw)
    n = {k: launches(k) - v for k, v in n.items()}
    want = pipeline.map_reads(on_cpu, reads, device="cpu", **kw)
    mapped = [(r, o) for r, o in zip(reads, got) if o["best"] is not None]
    assert len(mapped) == len(reads)
    n_plan = len(extension_plan([o["segments"][o["best"]] for _, o in mapped],
                                [len(r) for r, _ in mapped], len(ref),
                                True)[3])
    assert n == {"dp_ad": n_plan, "walk": n_plan}
    for g, w in zip(got, want):
        assert [(s["segment"], s["num_seeds"]) for s in g["segments"]] == \
            [(s["segment"], s["num_seeds"]) for s in w["segments"]]
        np.testing.assert_allclose(
            [(s["p"], *s["score"]) for s in g["segments"]],
            [(s["p"], *s["score"]) for s in w["segments"]],
            rtol=1e-5, atol=1e-6)
        assert g["best"] == w["best"] and g["rows"] == w["rows"]
        assert len(g["rows"]) == 1 and g["rows"][0]["score"] > 1000


def test_kmer_index_card_matches_cpu(rng, card):
    """The sorted (key, seq, pos) table, an append, hits, the k-mer
    scores and what masking drops, on the card and on the CPU."""
    from biseqt_tpu_torch.kmers import KmerIndex

    A4 = Alphabet("ACGT")
    reads = [Sequence(A4, rng.integers(0, 4, int(n)))
             for n in rng.integers(1500, 2500, 60)]
    reads.append(Sequence(A4, [0, 1, 2, 3] * 400))      # a repeat to mask
    on_card = KmerIndex(8, A4, device=card).index_kmers(reads[:40])
    on_cpu = KmerIndex(8, A4, device="cpu").index_kmers(reads[:40])
    on_card.index_kmers(reads[40:], append=True)
    on_cpu.index_kmers(reads[40:], append=True)
    for g, w in zip(on_card.table(), on_cpu.table()):
        assert g.device == card and torch.equal(g.cpu(), w)
    for km in on_cpu.kmers()[::997]:
        assert on_card.hits(km) == on_cpu.hits(km)
    (gu, gs), (wu, ws) = on_card.score_kmers(), on_cpu.score_kmers()
    assert np.array_equal(gu, wu)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    assert on_card.mask_repetitive(30.0) == on_cpu.mask_repetitive(30.0) > 0
    for g, w in zip(on_card.table(), on_cpu.table()):
        assert torch.equal(g.cpu(), w)


def test_wordblot_multiple_card_matches_cpu(rng, card):
    """Four 30 kbp sequences sharing two planted blocks: the N-way seeds,
    the segments and their seed counts on the card equal the CPU's,
    p-hat and (S0, S1) within rtol 1e-5, atol 1e-6, and both blocks
    are found."""
    from biseqt_tpu_torch.stochastics import MutationProcess

    A4 = Alphabet("ACGT")
    M = MutationProcess(A4, subst_probs=0.03, go_prob=0.005, ge_prob=0.02,
                        rng=rng)
    cores = [Sequence(A4, rng.integers(0, 4, 6000)) for _ in range(2)]
    flank = lambda: Sequence(A4, rng.integers(0, 4, int(rng.integers(
        5000, 7000))))
    seqs, blocks = [], []
    for n in range(4):
        f1, b1, f2, b2, f3 = (flank(), M.mutate(cores[0])[0], flank(),
                              M.mutate(cores[1])[0], flank())
        seqs.append(f1 + b1 + f2 + b2 + f3)
        if n == 0:
            blocks = [(len(f1), len(f1) + len(b1)),
                      (len(f1 + b1 + f2), len(f1 + b1 + f2 + b2))]
    kw = dict(wordlen=12)
    on_card = blot.WordBlotMultiple(*seqs, device=card, **kw)
    on_cpu = blot.WordBlotMultiple(*seqs, device="cpu", **kw)
    assert on_card.seed_index.seeds() == on_cpu.seed_index.seeds()
    got = list(on_card.similar_segments(K_min=2000, p_min=0.75))
    want = list(on_cpu.similar_segments(K_min=2000, p_min=0.75))
    assert [(s["segment"], s["num_seeds"]) for s in got] == \
        [(s["segment"], s["num_seeds"]) for s in want]
    np.testing.assert_allclose([(s["p"], *s["score"]) for s in got],
                               [(s["p"], *s["score"]) for s in want],
                               rtol=1e-5, atol=1e-6)
    for lo, hi in blocks:
        assert any(s["segment"][1][0] // 2 < hi and
                   s["segment"][1][1] // 2 > lo for s in got)


def test_wide_words_card_match_cpu(rng, card):
    """Words too wide for int32 keys (DNA word length 16, protein 8) on
    the fixed-reference and N-way paths: the reference's table, the
    segments and the N-way seeds on the card equal the CPU's."""
    from biseqt_tpu_torch.seeds import SeedIndexMultiple

    for alphabet, wordlen in ((Alphabet("ACGT"), 16),
                              (protein_alphabet(), 8)):
        A = len(alphabet)
        ref = Sequence(alphabet, rng.integers(0, A, 30_000))
        queries = [ref[r0:r0 + 2000] for r0 in (1000, 12_000, 25_000)]
        on_card = blot.WordBlotLocalRef(ref, wordlen=wordlen, device=card)
        on_cpu = blot.WordBlotLocalRef(ref, wordlen=wordlen, device="cpu")
        assert np.array_equal(on_card._ref_keys, on_cpu._ref_keys)
        assert np.array_equal(on_card._ref_pos, on_cpu._ref_pos)
        got = on_card.similar_segments_batch(queries, K_min=500, p_min=0.5)
        want = on_cpu.similar_segments_batch(queries, K_min=500, p_min=0.5)
        assert all(got) and [[(s["segment"], s["num_seeds"]) for s in g]
                             for g in got] == \
            [[(s["segment"], s["num_seeds"]) for s in w] for w in want]
        seqs = [ref[:6000], ref[3000:9000], ref[:9000]]
        seeds = SeedIndexMultiple(*seqs, wordlen=wordlen, device=card)
        assert len(seeds) > 2000
        assert seeds.seeds() == SeedIndexMultiple(
            *seqs, wordlen=wordlen, device="cpu").seeds()


# ---------------------------------------------------------------------------
# all-vs-all overlaps, the batch tier and two-tier protein search
# ---------------------------------------------------------------------------

def _tiled_reads(rng, n_reads, glen, rlen, err=0.12):
    from biseqt_tpu_torch.sequence import pack_sequences
    from biseqt_tpu_torch.stochastics import MutationProcess, rand_seq

    A4 = Alphabet("ACGT")
    M = MutationProcess(A4, subst_probs=err * 0.6, go_prob=err * 0.2,
                        ge_prob=err * 0.5, rng=rng)
    genome = rand_seq(A4, glen, rng=rng)
    reads = [M.mutate(genome[s:s + rlen])[0]
             for s in rng.integers(0, glen - rlen, n_reads)]
    return pack_sequences(reads)


def _assert_stats_card_equals_cpu(got, want, exact):
    for k in exact:
        assert torch.equal(got[k].cpu(), want[k]), k
    for k in ("p", "s0"):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("max_chunk", [None, 7])
def test_sorted_allvsall_card_matches_cpu(rng, card, max_chunk):
    """The sort-join engine (one window, and chunked windows with a
    shifted last one) on the card equals the CPU: window, diag and
    olap_len exactly, p and s0 within rtol 1e-5, atol 1e-6."""
    from biseqt_tpu_torch.ops.allvsall_sorted import (
        overlap_stats_sorted_chunked)

    codes, lens = _tiled_reads(rng, 40, 20_000, 3000)
    kw = dict(wordlen=8, n_reads=40, bucket=32, max_chunk=max_chunk)
    got = overlap_stats_sorted_chunked(codes, lens, device=card, **kw)
    want = overlap_stats_sorted_chunked(codes, lens, device="cpu", **kw)
    assert all(v.device == card for v in got.values())
    _assert_stats_card_equals_cpu(got, want, ("window", "diag", "olap_len"))


def test_blockwise_allvsall_card_matches_cpu(rng, card):
    from biseqt_tpu_torch.parallel import all_vs_all_overlaps, make_mesh
    from biseqt_tpu_torch.parallel.allvsall import overlap_stats_block

    codes, lens = _tiled_reads(rng, 24, 20_000, 3000)
    got = overlap_stats_block(codes, lens, codes, lens, wordlen=8,
                              device=card)
    want = overlap_stats_block(codes, lens, codes, lens, wordlen=8,
                               device="cpu")
    _assert_stats_card_equals_cpu(got, want, ("num_seeds", "diag",
                                              "olap_len"))
    pairs = lambda device: [p[:3] for p in all_vs_all_overlaps(
        codes, lens, method="blockwise", mesh=make_mesh(device=device),
        device=device)]
    assert pairs(card) == pairs("cpu")


def test_batch_mutations_card_match_cpu(card):
    """The materialisation on the card equals the CPU's on the same
    draws; the draws come from a generator on the card."""
    from biseqt_tpu_torch import stochastics

    gen = torch.Generator(device=card).manual_seed(1)
    codes = stochastics.rand_seq_batch(gen, 16, 3000, device=card)
    lens = torch.full((16,), 3000, dtype=torch.int32, device=card)
    draws = stochastics.batch_mutation_draws(gen, 16, 3000, 0.1, 0.05, 0.3,
                                             device=card)
    got = stochastics.apply_batch_mutations(codes, lens, draws, 0.3,
                                            device=card)
    want = stochastics.apply_batch_mutations(
        codes.cpu(), lens.cpu(), {k: v.cpu() for k, v in draws.items()},
        0.3, device="cpu")
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    with pytest.raises(ValueError, match="generator"):
        stochastics.rand_seq_batch(torch.Generator(), 2, 10, device=card)


@pytest.mark.parametrize("threshold", [40.0, 1e9])
def test_two_tier_card_matches_cpu(rng, card, threshold):
    """``two_tier_scores`` with K1 on the card (the filter at A 6, the
    rescore at A 20) equals K1's plain twin on the CPU exactly, and
    launches K1 once a tier."""
    from biseqt_tpu_torch.protein import two_tier_scores

    B, L = 64, 512
    ss = rng.integers(0, 20, (B, L)).astype(np.int8)
    ts = rng.integers(0, 20, (B, L)).astype(np.int8)
    hom = rng.random((B // 4, L)) < 0.75
    ts[:B // 4] = np.where(hom, ss[:B // 4], ts[:B // 4])
    lens = np.full((B,), L, np.int32)
    kw = dict(W=128, go=-11.0, ge=-1.0, w_eff=np.full((B,), 100, np.int32),
              flags=ModeFlags(local_start=True, local_end=True),
              threshold=threshold, engine="pallas")
    dmin = np.full((B,), -50, np.int32)
    before = launches("dp_ad")
    got = two_tier_scores(ss, ts, lens, lens, dmin, device=card, **kw)
    launched = launches("dp_ad") - before
    want = two_tier_scores(ss, ts, lens, lens, dmin, device="cpu", **kw)
    for name in ("reduced_scores", "survivors", "survivor_idx",
                 "full_scores"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    if threshold < 1e9:
        assert got.survivors[:B // 4].all() and launched == 2
        assert torch.equal(got.full.score.cpu(), want.full.score)
    else:
        assert got.full is None and launched == 1


def _sharded_pairs(rng, B, L):
    """Ragged homologous pairs (15% substitutions, T shifted by a few
    letters) for the band-sharded engines."""
    ss = rng.integers(0, 4, (B, L)).astype(np.int8)
    ts = np.roll(ss, rng.integers(-3, 4), axis=1)
    m = rng.random((B, L)) < 0.15
    ts[m] = (ts[m] + 1 + rng.integers(0, 3, m.sum())) % 4
    s_lens = (L - rng.integers(0, L // 10, B)).astype(np.int32)
    t_lens = (L - rng.integers(0, L // 10, B)).astype(np.int32)
    return ss, ts, s_lens, t_lens


# (B, L, W, halo, ckpt_chunks): the CPU tests' size (windows of 32 steps,
# run as written), and windows of 256 steps (a CUDA graph captured in the
# first window and replayed in every later one) over 700 letters
SHARDED_SHAPES = [(3, 150, 256, 16, 2), (2, 700, 256, 64, 4)]


@pytest.mark.parametrize("shape", SHARDED_SHAPES)
@pytest.mark.parametrize("flags", FLAG_CASES[:3])
def test_band_sharded_engines_card_match_cpu(rng, card, flags, shape):
    """The row engine, the antidiagonal engine (scores; with
    checkpoints: the band-gathered trackers and the checkpoints) and
    the traceback on a world-of-one mesh on the card equal the same
    calls on the CPU exactly."""
    from biseqt_tpu_torch.parallel import (band_sharded_ad_traceback,
                                           banded_dp_band_sharded,
                                           banded_dp_band_sharded_ad,
                                           make_mesh)
    from biseqt_tpu_torch.parallel.sharded_dp_ad import _run_band_sharded_ad

    B, L, W, halo, m = shape
    args = _sharded_pairs(rng, B, L) + (np.full((B,), -W // 2, np.int32),)
    w_eff = np.full((B,), W - 5, np.int32)
    out = []
    for device in (card, torch.device("cpu")):
        kw = dict(W=W, subst=UNIT, go=-2.0, ge=-1.0,
                  flags=ModeFlags(**flags), w_eff=w_eff,
                  mesh=make_mesh(device=device), device=device)
        row = banded_dp_band_sharded(*args, **kw)
        ad = banded_dp_band_sharded_ad(*args, halo=halo, **kw)
        fwd = _run_band_sharded_ad(*args, halo=halo, ckpt_every=m, **kw)
        tb = band_sharded_ad_traceback(*args, halo=halo, ckpt_chunks=m, **kw)
        assert row.device == ad.device == device
        out.append(([row.cpu(), ad.cpu()] + [x.cpu() for x in fwd], tb))
    (got, got_tb), (want, want_tb) = out
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert np.array_equal(got_tb[0], want_tb[0]) and got_tb[1] == want_tb[1]


def test_checkpointed_sweep_card_matches_cpu(rng, card, tmp_path):
    """The checkpointed sweep on the card (stopped after one block and
    resumed) equals the sweep on the CPU: integer fields exactly, p and
    s0 within rtol 1e-5, atol 1e-6."""
    from biseqt_tpu_torch.parallel import checkpointed_overlap_sweep

    codes, lens = _tiled_reads(rng, 24, 20_000, 3000)

    class Stop(Exception):
        pass

    def stop(done, total):
        if done == 1:
            raise Stop

    with pytest.raises(Stop):
        checkpointed_overlap_sweep(codes, lens, str(tmp_path / "card"),
                                   block=8, progress=stop, device=card)
    got = checkpointed_overlap_sweep(codes, lens, str(tmp_path / "card"),
                                     block=8, device=card)
    want = checkpointed_overlap_sweep(codes, lens, str(tmp_path / "cpu"),
                                      block=8, device="cpu")
    for k in ("num_seeds", "diag", "olap_len"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("p", "s0"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
