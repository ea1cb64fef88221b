"""The port's traceback walk (biseqt_tpu_torch.ops.walk) against the JAX
package's Pallas walks in interpret mode.

The port has one walk that writes the lane-packed layout of
``traceback_sweep_t``; it must equal that kernel byte for byte (trace
bytes and final cursors) on the same plane, and its transcripts, from
the port's ``compact_sweep_ops_t``, must equal both the sublane walk's
(``traceback_sweep`` + ``compact_sweep_ops``) and the C++ host walker's.
Reruns the cases of tests/test_pallas_walk.py.  The planes come from the
port's DP, which tests/test_torch_dp_ad.py holds to the JAX kernel.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from biseqt_tpu import native as ref_native
from biseqt_tpu.ops.banded_dp import ModeFlags as RefFlags
from biseqt_tpu.ops.pallas_walk import traceback_sweep, traceback_sweep_t
from biseqt_tpu.sequence import Alphabet
from biseqt_tpu.stochastics import rand_seq
from biseqt_tpu_torch import native, pipeline
from biseqt_tpu_torch.ops.banded_dp import ModeFlags
from biseqt_tpu_torch.ops.dp_ad import banded_dp_ad, parity_adjusted_dmin
from biseqt_tpu_torch.ops.walk import trace_moves, traceback_walk
from test_torch_cuda import UNIT, mk_batch

FLAG_CASES = [
    dict(local_start=True, local_end=True),
    dict(),
    dict(free_start_edges=True, free_end_edges=True),
    dict(free_start_edges=True, local_end=True),
]


def assert_walks_equal(dirs, dminq, ei, ej, W):
    """Port walk == traceback_sweep_t on one plane: trace bytes (the
    reference pads its rows to whole chunks, all zero past ours) and
    cursors.  Returns the port's ``(trace, fi, fj)`` as numpy."""
    tr, fi, fj = traceback_walk(torch.as_tensor(dirs), dminq, ei, ej, W=W,
                                device="cpu")
    r_tr, r_fi, r_fj = traceback_sweep_t(
        jnp.asarray(dirs), jnp.asarray(dminq), jnp.asarray(ei),
        jnp.asarray(ej), W=W, r_rows=8, interpret=True)
    tr, r_tr = tr.numpy(), np.asarray(r_tr)
    rows = tr.shape[1]
    assert tr.shape == (2, (dirs.shape[0] + 1) // 2, dirs.shape[1])
    np.testing.assert_array_equal(tr, r_tr[:, :rows, :tr.shape[2]])
    assert not r_tr[:, rows:].any()
    np.testing.assert_array_equal(fi.numpy(), np.asarray(r_fi))
    np.testing.assert_array_equal(fj.numpy(), np.asarray(r_fj))
    return tr, fi.numpy(), fj.numpy()


def dp_plane(args, w_eff, flags):
    res = banded_dp_ad(*args, W=128, subst=UNIT, go=-2.0, ge=-1.0,
                       flags=ModeFlags(**flags), w_eff=w_eff,
                       with_dirs=True, r_chunk=16, device="cpu")
    B = len(args[0])
    dminq = parity_adjusted_dmin(args[4], np.arange(B, dtype=np.int32) % 2)
    return res, dminq.astype(np.int32)


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_walk_matches_pallas_walks(rng, flags):
    args, w_eff = mk_batch(rng)
    ss, ts, s_lens, t_lens, _ = args
    res, dminq = dp_plane(args, w_eff, flags)
    dirs = res.dirs.numpy()
    live = res.score.numpy() > -1e29
    ei = np.where(live, res.end_i.numpy(), -1).astype(np.int32)
    ej = np.where(live, res.end_j.numpy(), -1).astype(np.int32)
    tr, fi, fj = assert_walks_equal(dirs, dminq, ei, ej, 128)
    f = RefFlags(**flags)
    ops, si, sj = native.compact_sweep_ops_t(tr, fi, fj, ss, ts, s_lens,
                                             t_lens, f)
    # the sublane walk (K3) on the same plane
    tr0, tr1, k_fi, k_fj = traceback_sweep(
        jnp.asarray(dirs), jnp.asarray(dminq), jnp.asarray(ei),
        jnp.asarray(ej), W=128, block_b=8, r_rows=8, interpret=True)
    k_ops, k_si, k_sj = ref_native.compact_sweep_ops(
        np.asarray(tr0), np.asarray(tr1), np.asarray(k_fi),
        np.asarray(k_fj), ss, ts, f)
    h_ops, h_si, h_sj = ref_native.traceback_batch_ad(
        dirs, dminq, ss, ts, s_lens, t_lens, res.end_i.numpy(),
        res.end_j.numpy(), f)
    assert ops == k_ops
    np.testing.assert_array_equal(si, k_si)
    np.testing.assert_array_equal(sj, k_sj)
    for b in np.nonzero(live)[0]:
        assert (ops[b], si[b], sj[b]) == (h_ops[b], h_si[b], h_sj[b])
    assert live.sum() >= len(ss) - 1


def test_walk_degenerate_and_skewed(rng):
    """Empty-origin global pair, free-end row-0 optimum, and a short T
    banding deep into a long S."""
    subst = np.full((4, 4), -100.0, np.float32)
    s = np.array([[2, 2]], np.int8)
    t = np.array([[0, 0]], np.int8)
    tl = np.array([1], np.int32)
    dmin = np.array([-64], np.int32)
    cases = [((s, t, np.array([0], np.int32), tl, dmin), subst, dict()),
             ((s, t, np.array([2], np.int32), tl, dmin), subst,
              dict(free_end_edges=True))]
    S = rng.integers(0, 4, 600).astype(np.int8)
    T = np.pad(S[481:581], (0, 28), constant_values=0)[None, :]
    cases.append(((S[None, :], T, np.array([600], np.int32),
                   np.array([100], np.int32), np.array([480], np.int32)),
                  UNIT, dict(local_start=True, local_end=True)))
    transcripts = []
    for args, sub, flags in cases:
        res = banded_dp_ad(*args, W=128, subst=sub, go=-2.0, ge=-1.0,
                           flags=ModeFlags(**flags),
                           w_eff=np.array([127], np.int32), with_dirs=True,
                           r_chunk=16, device="cpu")
        dminq = parity_adjusted_dmin(args[4], np.zeros(1, np.int32))
        ei, ej = res.end_i.numpy(), res.end_j.numpy()
        tr, fi, fj = assert_walks_equal(res.dirs.numpy(), dminq, ei, ej, 128)
        f = RefFlags(**flags)
        ops, si, sj = native.compact_sweep_ops_t(
            tr, fi, fj, args[0], args[1], args[2], args[3], f)
        h_ops, h_si, h_sj = ref_native.traceback_batch_ad(
            res.dirs.numpy(), dminq, *args[:4], ei, ej, f)
        assert (ops[0], si[0], sj[0]) == (h_ops[0], h_si[0], h_sj[0])
        transcripts.append(ops[0])
    assert transcripts[0] == "I"       # the all-gap global transcript
    assert transcripts[2].count("M") > 90


@pytest.mark.parametrize("B2,Rp,W", [(130, 16, 128), (130, 12, 256),
                                     (20, 16, 128)])
def test_walk_random_planes(rng, B2, Rp, W):
    """Random nibble planes (every source and gap bit pattern), cursors
    inside the band, skipped pairs and a ragged pair count."""
    B = 2 * B2 - (3 if B2 == 20 else 0)
    dirs = rng.integers(0, 256, (Rp, B2, W)).astype(np.uint8)
    dminq = rng.integers(-W + 1, 1, B).astype(np.int32)
    ei = rng.integers(1, Rp, B).astype(np.int32)
    ej = np.clip(ei - dminq - rng.integers(0, W, B), 0, Rp - 1
                 ).astype(np.int32)
    ei[::7] = -1
    assert_walks_equal(dirs, dminq, ei, ej, W)


def test_walk_empty_plane():
    for B2, Rp in ((3, 0), (0, 0)):
        B = 2 * B2
        tr, fi, fj = traceback_walk(
            torch.zeros((Rp, B2, 128), dtype=torch.uint8),
            np.zeros(B, np.int32), np.full(B, 5, np.int32),
            np.full(B, 7, np.int32), W=128, device="cpu")
        assert tuple(tr.shape) == (2, 0, B2)
        np.testing.assert_array_equal(fi.numpy(), np.full(B, 5))
        np.testing.assert_array_equal(fj.numpy(), np.full(B, 7))


def test_compactor_rejects_cursor_outside_matrix(rng):
    """A walk cursor past its pair's matrix would make the C++ replay
    read the neighbouring pair's row: the wrapper refuses it."""
    args, w_eff = mk_batch(rng)
    ss, ts, s_lens, t_lens, _ = args
    flags = dict(local_start=True, local_end=True)
    res, dminq = dp_plane(args, w_eff, flags)
    tr, fi, fj = traceback_walk(res.dirs, dminq, res.end_i, res.end_j,
                                W=128, device="cpu")
    tr, fi, fj = tr.numpy(), fi.numpy(), fj.numpy()
    f = ModeFlags(**flags)
    ops, _, _ = native.compact_sweep_ops_t(tr, fi, fj, ss, ts, s_lens,
                                           t_lens, f)
    assert all(ops)
    for field, value in (("i", s_lens[1] + 1), ("j", t_lens[3] + 5),
                         ("i", 10 ** 6)):
        bad_i, bad_j = fi.copy(), fj.copy()
        if field == "i":
            bad_i[1] = value
        else:
            bad_j[3] = value
        with pytest.raises(ValueError, match="outside their pair"):
            native.compact_sweep_ops_t(tr, bad_i, bad_j, ss, ts, s_lens,
                                       t_lens, f)


@pytest.mark.parametrize("with_moves", [False, True])
def test_compactor_rejects_replay_past_matrix(with_moves):
    """Six diagonal ops from (0, 0) on a 4 x 4 pair: the cursors are
    inside the matrix, but the replay would read two letters of the next
    pair ('MMMMSS').  Refused whether the moves are counted by the
    compactor or passed in."""
    trace = np.zeros((2, 2, 1), np.uint8)
    trace[0, :, 0] = (0x55, 0x05)          # op 1 at steps 0..5 of pair 0
    s = np.array([[0, 1, 2, 3], [1, 1, 1, 1]], np.int8)
    t = np.array([[0, 1, 2, 3], [2, 2, 2, 2]], np.int8)
    lens = np.array([4, 4], np.int32)
    zero = np.zeros(2, np.int32)
    kw = dict(moves=(np.array([6, 0]), np.array([6, 0]))) if with_moves \
        else {}
    with pytest.raises(ValueError, match="leave its pair's matrix"):
        native.compact_sweep_ops_t(trace, zero, zero, s, t, lens, lens,
                                   ModeFlags(local_start=True), **kw)
    # four diagonal ops stay inside: 'MMMM'
    trace[0, 1, 0] = 0
    ops, _, _ = native.compact_sweep_ops_t(trace, zero, zero, s, t, lens,
                                           lens, ModeFlags(local_start=True))
    assert ops == ["MMMM", ""]


def _numpy_moves(trace, B):
    ops = (trace[..., None] >> np.array([0, 2, 4, 6])) & 3
    di = ((ops == 1) | (ops == 3)).sum(axis=(1, 3))      # [2, B2]
    dj = ((ops == 1) | (ops == 2)).sum(axis=(1, 3))
    return di.T.reshape(-1)[:B], dj.T.reshape(-1)[:B]


@pytest.mark.parametrize("kind", ["random", "real"])
def test_trace_moves_matches_numpy_count(rng, kind):
    """trace_moves against a plain numpy count, on random bytes and on a
    real walk's trace, where the moves lead from end to start cells."""
    if kind == "random":
        trace = rng.integers(0, 256, (2, 37, 11)).astype(np.uint8)
        B = 21
    else:
        args, w_eff = mk_batch(rng)
        res, dminq = dp_plane(args, w_eff, dict(local_start=True,
                                                local_end=True))
        trace, fi, fj = traceback_walk(res.dirs, dminq, res.end_i,
                                       res.end_j, W=128, device="cpu")
        trace = trace.numpy()
        B = len(dminq)
    di, dj = trace_moves(torch.from_numpy(trace), B)
    assert di.dtype == dj.dtype == torch.int32 and di.shape == (B,)
    want_di, want_dj = _numpy_moves(trace, B)
    np.testing.assert_array_equal(di.numpy(), want_di)
    np.testing.assert_array_equal(dj.numpy(), want_dj)
    if kind == "real":
        np.testing.assert_array_equal(di, res.end_i - fi)
        np.testing.assert_array_equal(dj, res.end_j - fj)
        assert di.numpy().max() > 100


def test_extend_segments_rejects_trace_off_its_end_cells(rng, monkeypatch):
    """A walk whose trace does not lead from the end cells to its final
    cursors (one diagonal op turned into an insertion) is refused before
    the replay."""
    A4 = Alphabet("ACGT")
    S = rand_seq(A4, 400, rng=rng)
    seg = {"segment": ((-8, 8), (100, 700))}
    kw = dict(go_score=-3.0, ge_score=-1.0, with_transcripts=True,
              device="cpu", _r_chunk=16)
    good = pipeline.extend_segments(S, S, [seg], **kw)
    assert good[0]["transcript"].count("M") > 200

    def corrupt(*args, **kwargs):
        trace, fi, fj = traceback_walk(*args, **kwargs)
        trace = trace.clone()
        row = int(torch.nonzero(trace[0, :, 0] & 3 == 1)[0, 0])
        trace[0, row, 0] += 1               # the op of its first step: 1 -> 2
        return trace, fi, fj

    monkeypatch.setattr(pipeline, "traceback_walk", corrupt)
    with pytest.raises(RuntimeError, match="does not lead from the end"):
        pipeline.extend_segments(S, S, [seg], **kw)
