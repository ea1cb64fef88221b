"""The compaction of the walk's op trace on the device
(biseqt_tpu_torch.ops.compact) against the C++ compactor
(``native.compact_sweep_ops_t``), on the CPU through the plain twin.

The op must give the C++ binding's transcripts and start cells byte for
byte, count the trace's moves as ``walk.trace_moves`` does, and raise
where the binding raises; where the binding trusts its inputs the op
marks the pair's row bad (-1) and reads nothing of it.  The kernel is
held to the twin on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from biseqt_tpu_torch import native, pipeline
from biseqt_tpu_torch.ops import compact
from biseqt_tpu_torch.ops.banded_dp import ModeFlags
from biseqt_tpu_torch.ops.dp_ad import banded_dp_ad, parity_adjusted_dmin
from biseqt_tpu_torch.ops.walk import trace_moves, traceback_walk
from biseqt_tpu_torch.sequence import Alphabet, Sequence
from test_torch_cuda import UNIT, mk_batch, random_traces

# local, anchored, free and mixed starts (anchored modes put D^i I^j
# first)
FLAG_CASES = [
    dict(local_start=True, local_end=True),
    dict(),
    dict(free_start_edges=True, free_end_edges=True),
    dict(free_start_edges=True, local_end=True),
    dict(local_end=True),
]

T = torch.from_numpy


def via_op(trace, fi, fj, ss, ts, s_lens, t_lens, flags):
    """The op's twin on numpy inputs, then the host decode: ``(ops,
    start_i, start_j)`` as the C++ binding returns them, and the op's
    raw outputs."""
    out = compact.compact(
        T(np.ascontiguousarray(trace)), T(np.asarray(fi, np.int32)),
        T(np.asarray(fj, np.int32)), T(np.asarray(ss, np.int8)),
        T(np.asarray(ts, np.int8)), T(np.asarray(s_lens, np.int32)),
        T(np.asarray(t_lens, np.int32)), flags)
    ops, ops_len, di, dj = (x.numpy() for x in out)
    got = compact.transcripts(ops, ops_len, fi, fj, (di, dj), s_lens,
                              t_lens, flags)
    return got, out


def assert_same(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def walked(rng, flags, skip=()):
    """A real walk's trace over the DP's plane of ``mk_batch`` (five
    ragged pairs, an odd batch), with the pairs of ``skip`` skipped."""
    args, w_eff = mk_batch(rng)
    res = banded_dp_ad(*args, W=128, subst=UNIT, go=-2.0, ge=-1.0,
                       flags=ModeFlags(**flags), w_eff=w_eff,
                       with_dirs=True, r_chunk=16, device="cpu")
    B = len(args[0])
    dminq = parity_adjusted_dmin(args[4], np.arange(B, dtype=np.int32) % 2)
    ei, ej = res.end_i.numpy().copy(), res.end_j.numpy().copy()
    ei[list(skip)] = -1
    tr, fi, fj = traceback_walk(res.dirs, dminq, ei, ej, W=128, device="cpu")
    return args, tr.numpy(), fi.numpy(), fj.numpy()


@pytest.mark.parametrize("skip", [(), (1, 4)])
@pytest.mark.parametrize("flags", FLAG_CASES)
def test_twin_equals_the_cpp_compactor_on_walks(rng, flags, skip):
    (ss, ts, s_lens, t_lens, _), tr, fi, fj = walked(rng, flags, skip)
    f = ModeFlags(**flags)
    want = native.compact_sweep_ops_t(tr, fi, fj, ss, ts, s_lens, t_lens, f)
    got, (_, ops_len, di, dj) = via_op(tr, fi, fj, ss, ts, s_lens, t_lens,
                                       f)
    assert_same(got, want)
    moves = trace_moves(T(tr), len(ss))
    assert torch.equal(di, moves[0]) and torch.equal(dj, moves[1])
    assert all(ops_len[list(skip)] == 0) and not any(got[0][k] for k in skip)
    assert sum(map(len, got[0])) > 50 * (len(ss) - len(skip))


@pytest.mark.parametrize("B2,B,rows,dense", [(1, 1, 1, 1.0), (4, 7, 9, 0.5),
                                             (13, 25, 40, 0.9),
                                             (6, 12, 3, 0.2)])
@pytest.mark.parametrize("flags", FLAG_CASES[:3])
def test_twin_equals_the_cpp_compactor_on_random_traces(rng, flags, B2, B,
                                                        rows, dense):
    tr, *rest = random_traces(rng, B2, B, rows, dense)
    f = ModeFlags(**flags)
    want = native.compact_sweep_ops_t(tr, *rest, f)
    got, _ = via_op(tr, *rest, f)
    assert_same(got, want)
    assert max(map(len, got[0])) > 0


def test_twin_replays_from_inside_a_byte():
    """Start cells whose antidiagonal is not a multiple of four: the ops
    of their byte row below them are not replayed (though counted as
    moves), as in the C++ replay."""
    tr = np.zeros((2, 3, 1), np.uint8)
    tr[0, :, 0] = (0b11_01_10_01, 0b01_01_01_01, 0b00_00_10_11)
    ss = np.array([[0, 1, 2, 3, 0, 1, 2, 3, 0, 1]], np.int8)
    lens = np.array([10], np.int32)
    f = ModeFlags(local_start=True)
    got = {}
    for fi, fj in ((0, 0), (1, 0), (1, 1), (2, 1)):
        args = (tr, np.array([fi], np.int32), np.array([fj], np.int32), ss,
                ss, lens, lens, f)
        got[fi, fj], _ = via_op(*args)
        assert_same(got[fi, fj], native.compact_sweep_ops_t(*args))
    assert got[0, 0][0] == ["MISDMMMMDI"]
    assert got[2, 1][0] == ["DSSSSDI"]


@pytest.mark.parametrize("field,pair,value", [
    ("i", 1, "s_len + 1"), ("j", 3, "t_len + 5"), ("i", 1, "10 ** 6"),
    ("j", 0, "2 ** 31 - 1")])
def test_cursor_outside_the_matrix_raises_and_reads_nothing(
        rng, field, pair, value):
    """A cursor past its pair's matrix: the binding raises ValueError,
    the op marks that pair's row bad and leaves the others whole."""
    f = ModeFlags(local_start=True, local_end=True)
    (ss, ts, s_lens, t_lens, _), tr, fi, fj = walked(
        rng, dict(local_start=True, local_end=True))
    good = native.compact_sweep_ops_t(tr, fi, fj, ss, ts, s_lens, t_lens, f)
    bad_i, bad_j = fi.copy(), fj.copy()
    cursor = bad_i if field == "i" else bad_j
    cursor[pair] = eval(value, {"s_len": s_lens[pair],
                                "t_len": t_lens[pair]})
    with pytest.raises(ValueError, match="outside their pair"):
        native.compact_sweep_ops_t(tr, bad_i, bad_j, ss, ts, s_lens, t_lens,
                                   f)
    with pytest.raises(ValueError, match="outside their pair"):
        via_op(tr, bad_i, bad_j, ss, ts, s_lens, t_lens, f)
    out = compact.compact(T(tr), T(bad_i), T(bad_j), T(ss), T(ts),
                          T(s_lens), T(t_lens), f)
    ops, ops_len = out[0].numpy(), out[1].numpy()
    assert ops_len[pair] == -1 and not ops[pair].any()
    for b in set(range(len(ss))) - {pair}:
        assert ops[b, :ops_len[b]].tobytes().decode() == good[0][b]


@pytest.mark.parametrize("corrupt", ["replay", "byte"])
def test_trace_that_leaves_the_matrix_raises(corrupt):
    """Six diagonal ops from (0, 0) on a 4 x 4 pair: the cursors are
    inside the matrix, but the replay would read two letters of the next
    pair ('MMMMSS'); or a corrupted byte turns two of four diagonals into
    deletions past the rows.  Both raise as the binding does, and the
    op's row is bad."""
    trace = np.zeros((2, 2, 1), np.uint8)
    if corrupt == "replay":
        trace[0, :, 0] = (0x55, 0x05)       # op 1 at steps 0..5 of pair 0
    else:
        trace[0, :, 0] = (0x55, 0x0F)       # then two deletions
    s = np.array([[0, 1, 2, 3], [1, 1, 1, 1]], np.int8)
    t = np.array([[0, 1, 2, 3], [2, 2, 2, 2]], np.int8)
    lens = np.array([4, 4], np.int32)
    zero = np.zeros(2, np.int32)
    f = ModeFlags(local_start=True)
    with pytest.raises(ValueError, match="leave its pair's matrix"):
        native.compact_sweep_ops_t(trace, zero, zero, s, t, lens, lens, f)
    with pytest.raises(ValueError, match="leave its pair's matrix"):
        via_op(trace, zero, zero, s, t, lens, lens, f)
    _, ops_len, _, _ = compact.compact(T(trace), T(zero), T(zero), T(s),
                                       T(t), T(lens), T(lens), f)
    assert ops_len.tolist() == [-1, 0]
    # four diagonal ops stay inside: 'MMMM'
    trace[0, 1, 0] = 0
    got, _ = via_op(trace, zero, zero, s, t, lens, lens, f)
    assert got[0] == ["MMMM", ""]


def test_overrun_raises_runtime_error():
    """A row marked bad by the op whose cursors and moves pass the
    host's checks is an overrun: RuntimeError, as the binding's."""
    ops = np.zeros((2, 8), np.uint8)
    with pytest.raises(RuntimeError, match="overran for pairs \\[1\\]"):
        compact.transcripts(ops, np.array([0, -1], np.int32), [0, 0], [0, 0],
                            ([0, 0], [0, 0]), [3, 3], [3, 3],
                            ModeFlags(local_start=True))


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    tr, fi, fj, ss, ts, sl, tl = (T(x) for x in random_traces(rng, 2, 3, 4,
                                                              0.5))
    f = ModeFlags(local_start=True)
    for bad in (dict(trace=tr.int()), dict(fin_i=fi.long()),
                dict(s_codes=ss.to(torch.uint8)), dict(t_lens=tl[None]),
                dict(trace=tr.numpy()), dict(trace=tr[0])):
        kw = dict(trace=tr, fin_i=fi, fin_j=fj, s_codes=ss, t_codes=ts,
                  s_lens=sl, t_lens=tl, mode_flags=f)
        kw.update(bad)
        with pytest.raises(ValueError):
            compact.compact(**kw)
    # as many pairs as every input holds: three of the four the trace
    # has columns for, none of an empty batch
    ops, ops_len, di, dj = compact.compact(tr, fi, fj, ss, ts, sl, tl, f)
    assert tr.shape[2] == 2 and ops.shape == (3, ss.shape[1] + ts.shape[1]
                                              + 2)
    ops, ops_len, di, dj = compact.compact(tr[:, :, :0], fi, fj, ss, ts, sl,
                                           tl, f)
    assert ops.shape == (0, ss.shape[1] + ts.shape[1] + 2)
    assert ops_len.shape == di.shape == dj.shape == (0,)


@pytest.mark.parametrize("rows,threads", [
    (6176, 512), (98_336, 1024), (10 ** 7, 1024), (1, 32), (0, 32),
    (512, 32), (513, 64), (16_384, 1024), (16_385, 1024)])
def test_plan_follows_the_trace_length(rows, threads):
    """A block of a power of two of 32 to 1024 threads, the fewest that
    replay the trace in at most ROUNDS rounds while the block has
    room."""
    got = compact.plan(rows)
    assert got == threads
    assert got * compact.ROUNDS >= rows or got == compact.MAX_THREADS
    assert got == 32 or (got // 2) * compact.ROUNDS < rows


def test_dp_returns_the_codes_it_read(rng):
    (ss, ts, s_lens, t_lens, dmin), w_eff = mk_batch(rng)
    kw = dict(W=128, subst=UNIT, go=-2.0, ge=-1.0,
              flags=ModeFlags(local_start=True, local_end=True),
              w_eff=w_eff, with_dirs=True, r_chunk=16, device="cpu")
    res, codes = banded_dp_ad(ss, ts, s_lens, t_lens, dmin,
                              return_codes=True, **kw)
    plain = banded_dp_ad(ss, ts, s_lens, t_lens, dmin, **kw)
    assert all(torch.equal(a, b) for a, b in zip(res, plain))
    s_dev, t_dev, sl_dev, tl_dev = codes
    B = len(ss)
    assert s_dev.shape == (B + 1, ss.shape[1])        # whole plane rows
    np.testing.assert_array_equal(s_dev[:B].numpy(), ss)
    np.testing.assert_array_equal(t_dev[:B].numpy(), ts)
    np.testing.assert_array_equal(sl_dev.numpy(), s_lens)
    np.testing.assert_array_equal(tl_dev.numpy(), t_lens)


def _one_launch(rng, n_segments):
    A4 = Alphabet("ACGT")
    S = Sequence(A4, rng.integers(0, 4, 1500))
    Tq = S.to_array().copy()
    hit = rng.random(len(Tq)) < 0.1
    Tq[hit] = (Tq[hit] + 1) % 4
    Tq = Sequence(A4, Tq)
    segs = [{"segment": ((-8, 8), (600 + 300 * k, 1100 + 300 * k))}
            for k in range(n_segments)]
    flags = ModeFlags(local_start=True, local_end=True)
    _, _, cut, launches = pipeline.extension_plan(segs, len(S), len(Tq),
                                                  True)
    (idxs, LS, LT, W), = launches
    x = pipeline.launch_inputs(cut, idxs, LS, LT, W, S.to_array(),
                               Tq.to_array(), True)
    dp_kw = dict(subst=UNIT, go=-3.0, ge=-1.0, flags=flags, r_chunk=16)
    return idxs, x, W, dp_kw, flags


@pytest.mark.parametrize("n_segments", [1, 3])
def test_walk_route_on_the_cpu_equals_the_host_compaction(rng, n_segments):
    """The pipeline's walk route (the trace compacted where it was walked,
    its bytes and lengths copied) on the CPU through the twin equals the
    CPU's route (the trace compacted by the C++ tier), padding pairs
    included."""
    idxs, x, W, dp_kw, flags = _one_launch(rng, n_segments)
    cpu = torch.device("cpu")
    out = {}
    for route in ("walk", "trace"):
        launch = pipeline._dispatch(idxs, x, W, dp_kw, True, route, cpu)
        out[route] = pipeline._finish(launch, flags, True)
    np.testing.assert_array_equal(out["walk"][0], out["trace"][0])
    assert_same(out["walk"][1], out["trace"][1])
    assert len(out["walk"][1][0]) == len(idxs)
    assert all(len(ops) > 100 for ops in out["walk"][1][0])


def test_walk_route_refuses_a_trace_off_its_end_cells(rng, monkeypatch):
    """A corrupted byte of the walk's trace (a diagonal op turned into an
    insertion) is caught by the walk route's check of the op's moves."""
    idxs, x, W, dp_kw, flags = _one_launch(rng, 1)

    def corrupt(*args, **kwargs):
        trace, fi, fj = traceback_walk(*args, **kwargs)
        trace = trace.clone()
        row = int(torch.nonzero(trace[0, :, 0] & 3 == 1)[0, 0])
        trace[0, row, 0] += 1
        return trace, fi, fj

    monkeypatch.setattr(pipeline, "traceback_walk", corrupt)
    launch = pipeline._dispatch(idxs, x, W, dp_kw, True, "walk",
                                torch.device("cpu"))
    with pytest.raises(RuntimeError, match="does not lead from the end"):
        pipeline._finish(launch, flags, True)
