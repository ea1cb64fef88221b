"""Pure-Python models of the bookkeeping of the CUDA kernel K4
(``biseqt_tpu_torch/csrc/dp_row.cu``), held to its plain twin
(``ops/dp_row.py``) on the CPU.

The kernel runs every float add of the twin with the twin's operands;
what it does differently is how the work is laid out: the planner's
geometry (which thread owns which lanes), the grouping of the E chain's
prefix max (a serial run over a thread's lanes, a warp scan of the
thread totals, a carry across warps through shared memory), the T codes
kept in registers and shifted down a lane a row, and the S codes
broadcast from blocks of 32.  These tests replay that bookkeeping (the
kernel itself runs only on the card) and require it to give the twin's
values exactly.
"""

import numpy as np
import pytest
import torch

from biseqt_tpu_torch.ops import dp_row
from biseqt_tpu_torch.ops.banded_dp import ModeFlags

from test_torch_cuda import UNIT, mk_row_batch

NEGF = np.float32(-1e30)
NINF = np.float32(-np.inf)


@pytest.mark.parametrize("with_dirs", [False, True])
@pytest.mark.parametrize("B", [1, 2, 131, 4096])
@pytest.mark.parametrize("W", [128, 256, 384, 512, 1024, 2048, 2176, 4096])
def test_plan_owns_every_lane_once(W, B, with_dirs):
    """The planner's geometry is an instance the kernel has, its blocks
    fit the card's limit, every pair gets one block (of one warp for a
    warp per pair), and every lane of a pair is owned by exactly one
    thread (a block's last warp may own dead lanes past W, less than a
    warp's worth).  Below as many pairs as SMs, with directions, a wide
    band takes 4 lanes a thread."""
    g = dp_row.plan(B, W, with_dirs, sms=132)
    g.check(W)
    per_pair = g.threads(W)
    assert 32 <= per_pair <= 1024 and per_pair % 32 == 0
    if g.warp_per_pair:
        assert g.lpt in dp_row.WARP_LPT and W == 32 * g.lpt
        assert per_pair == 32
    else:
        assert g.lpt in dp_row.BLOCK_LPT
        assert per_pair <= dp_row.MAX_BLOCK_THREADS
        assert g.lpt == (4 if with_dirs and B < 132 and W <= 2048 else 8)
    lanes = np.array([t * g.lpt + m for t in range(per_pair)
                      for m in range(g.lpt)])
    assert len(set(lanes)) == len(lanes) and set(range(W)) <= set(lanes)
    assert lanes.max() < W + 32 * g.lpt


@pytest.mark.parametrize("with_dirs", [False, True])
@pytest.mark.parametrize("W", [4224, 5120, 6144, 8192, 12288, 16384, 24576,
                               32768, 49152, 65536])
def test_cluster_plan_owns_every_lane_once(W, with_dirs):
    """Above 4096 lanes the planner takes a cluster of the fewest blocks
    of at most 512 threads x 8 lanes (at most 8 blocks to W 32768, 16 to
    W 65536), the pair's warps numbered across its blocks: every lane of
    the pair is owned by exactly one thread of one block, the dead lanes
    past W are fewer than a warp's worth a block, and a block's first
    lane is a multiple of its width."""
    g = dp_row.plan(1, W, with_dirs, sms=132)
    g.check(W)
    assert not g.warp_per_pair and g.lpt == dp_row.CLUSTER_LPT
    assert 2 <= g.cluster <= (8 if W <= dp_row.PORTABLE_W else 16)
    assert g.cluster == -(-W // (dp_row.CLUSTER_LPT * 512))
    nt = g.threads(W)
    assert nt <= dp_row.MAX_BLOCK_THREADS and nt % 32 == 0
    lanes = np.array([(r * nt + t) * g.lpt + m for r in range(g.cluster)
                      for t in range(nt) for m in range(g.lpt)])
    assert len(set(lanes)) == len(lanes) and set(range(W)) <= set(lanes)
    assert lanes.max() < W + g.cluster * 32 * g.lpt
    with pytest.raises(ValueError):
        dp_row.Geometry(g.lpt, False).check(W)     # one block is too few
    with pytest.raises(ValueError):
        dp_row.Geometry(4, False, g.cluster).check(W)


@pytest.mark.parametrize("W,lpt,threads", [
    (128, 4, 32), (384, 8, 64), (2048, 4, 512), (2176, 8, 288),
    (4096, 8, 512)])
def test_check_refuses_what_the_kernel_has_not(W, lpt, threads):
    """A block per pair is the fewest whole warps that cover W; the
    kernel has 4 and 8 lanes a thread, at most 512 threads, and a warp
    per pair only where 32 threads own W."""
    g = dp_row.Geometry(lpt, False)
    g.check(W)
    assert g.threads(W) == threads
    for bad in (dp_row.Geometry(2, False), dp_row.Geometry(16, True),
                dp_row.Geometry(4 if W > 128 else 8, True)):
        with pytest.raises(ValueError):
            bad.check(W)
    assert dp_row.Geometry(W // 32, True).threads(W) == 32
    with pytest.raises(ValueError):
        dp_row.Geometry(4, False).check(2176)     # 544 threads


def twin_rows(monkeypatch, args, w_eff, W, flags, with_dirs):
    """Every row's E-chain terms of the plain twin: the cummax input X
    (X[k] = H_pre[k-1] + cgek[k], X[0] = NEG + cgek[0]) and its output P,
    as numpy [rows, B, W] float32."""
    xs, ps = [], []
    cummax = torch.cummax

    def spy(x, dim):
        out = cummax(x, dim=dim)
        xs.append(x.numpy().copy())
        ps.append(out.values.numpy().copy())
        return out

    monkeypatch.setattr(torch, "cummax", spy)
    dp_row.banded_dp_row(*args, W=W, subst=UNIT, go=-2.5, ge=-1.0,
                         flags=flags, w_eff=w_eff, with_dirs=with_dirs,
                         device="cpu")
    monkeypatch.undo()
    return np.stack(xs), np.stack(ps)


def grouped_scan(X, lpt, nw, A0):
    """The kernel's prefix max of one row of one pair in a geometry of
    ``nw`` warps (1: a warp per pair) of 32 threads with ``lpt`` lanes
    each, the lanes past W dead.  From Q[k] = X[k + 1] (the Q of lane
    W - 1 and of the dead lanes, which no lane's P may see, is +inf
    here) returns P at every lane below W and Pprev at every thread's
    first lane (P of the lane below it, the E-extend bit's other
    side)."""
    W = X.shape[0]
    assert W <= 32 * lpt * nw < W + 32 * lpt
    Q = np.concatenate([X[1:], np.full(32 * lpt * nw - W + 1, np.inf,
                                       np.float32)])
    nt = 32 * nw
    inc = np.empty((nt, lpt), np.float32)
    for t in range(nt):                      # the serial run
        run = NINF
        for m in range(lpt):
            run = max(run, Q[t * lpt + m])
            inc[t, m] = run
    tot = inc[:, -1].reshape(nw, 32)
    x = tot.copy()                           # shfl_up scan, own value
    off = 1                                  # below off
    while off < 32:
        y = np.concatenate([x[:, :off], x[:, :-off]], axis=1)
        x = np.maximum(x, y)
        off *= 2
    excl = np.concatenate([np.full((nw, 1), NINF), x[:, :-1]], axis=1)
    # shared memory: each warp's total, and its total without its top lane
    wtot = x[:, 31]
    wx = np.maximum(excl[:, 31], inc.reshape(nw, 32, lpt)[:, 31, -2]) \
        if lpt > 1 else excl[:, 31]
    P = np.empty((nt, lpt), np.float32)
    pprev = np.empty(nt, np.float32)
    top_view = []
    for w in range(nw):
        c2 = np.max(wtot[:w - 1], initial=NINF) if w > 1 else NINF
        carry = max(c2, wtot[w - 1]) if w > 0 else NINF
        pprev0 = max(A0, max(c2, wx[w - 1])) if w > 0 else NEGF
        for lane in range(32):
            t = 32 * w + lane
            base = max(A0, max(carry, excl[w, lane]))
            P[t, 0] = base
            for m in range(1, lpt):
                P[t, m] = max(base, inc[t, m - 1])
        for lane in range(32):
            t = 32 * w + lane
            pprev[t] = pprev0 if lane == 0 else P[t - 1, -1]
        # the top thread's view of the next warp's first lane
        top_view.append(max(A0, max(carry, wtot[w])))
    for w in range(nw - 1):
        assert top_view[w] == P[32 * (w + 1), 0]
    return P.reshape(-1)[:W], pprev


@pytest.mark.parametrize("W,lpt,nw", [
    (128, 4, 1), (256, 8, 1), (256, 4, 2), (384, 4, 3), (384, 8, 2),
    (512, 4, 4), (512, 8, 2), (1280, 8, 5), (1152, 8, 5), (5120, 8, 20)])
@pytest.mark.parametrize("flags", [dict(local_start=True, local_end=True),
                                   dict(), dict(free_start_edges=True,
                                                free_end_edges=True)])
def test_grouped_scan_is_the_twins_cummax(monkeypatch, W, lpt, nw, flags):
    """Serial run, warp scan and carry give the twin's cummax at every
    lane of every row, bit for bit, and each thread's Pprev is the twin's
    shr(P) at its first lane (thread and warp edges both)."""
    rng = np.random.default_rng(W + 7 * lpt)
    args, w_eff = mk_row_batch(rng, W=W, L=120)
    X, P = twin_rows(monkeypatch, args, w_eff, W, ModeFlags(**flags),
                     with_dirs=True)
    gg = np.float32(-2.5 + -1.0)
    A0 = np.float32(NEGF + gg)
    firsts = np.arange(0, 32 * lpt * nw, lpt)
    checked = 0
    for row in range(0, X.shape[0], 7):
        for b in range(X.shape[1]):
            assert X[row, b, 0] == A0
            got, pprev = grouped_scan(X[row, b], lpt, nw, A0)
            assert np.array_equal(got.view(np.int32),
                                  P[row, b].view(np.int32))
            shr = np.concatenate([[NEGF], P[row, b, :-1]])
            live = firsts < W
            assert np.array_equal(pprev[live], shr[firsts[live]])
            checked += 1
    assert checked > 50


def t_column(t, tlen, idx, A):
    """The kernel's table column of T position idx (A: the pad)."""
    if 0 <= idx < tlen and t[idx] >= 0:
        return int(t[idx])
    return A


def window_model(s, t, slen, tlen, dmax, W, lpt, nw, A):
    """Replays the kernel's code registers for one pair: per row i (1 ..
    slen) the column each lane looks up and the S code of its table row,
    as the kernel's shifts, shuffles and 32-row blocks produce them."""
    nt = 32 * nw
    k0 = np.arange(nt) * lpt
    kt = (np.arange(nt) // 32) * 32 * lpt + 32 * lpt - 1   # warp's top lane
    lane = np.arange(nt) % 32

    def s_block(i0):
        return [int(s[i0 - 1 + l]) if i0 - 1 + l < slen else 0
                for l in lane]

    def t_block(i0):
        return [t_column(t, tlen, i0 + lane[x] + kt[x] - dmax, A)
                for x in range(nt)]

    sv, tv, sv_n, tv_n = s_block(1), t_block(1), s_block(33), t_block(33)
    code = np.array([[t_column(t, tlen, k0[x] + m - dmax, A)
                      for m in range(lpt)] for x in range(nt)])
    sc = sv[0]
    cols, srows = [], []
    for i in range(1, slen + 1):
        r = (i - 1) % 32
        if r == 0 and i > 1:
            sv, tv = sv_n, tv_n
            sv_n, tv_n = s_block(i + 32), t_block(i + 32)
        cols.append(code.reshape(-1).copy())
        srows.append(sc)
        # the next row: shift down a lane, the top lane's from the block
        new = np.empty_like(code)
        new[:, :-1] = code[:, 1:]
        for x in range(nt):
            w = x // 32
            new[x, -1] = (code[x + 1, 0] if lane[x] < 31
                          else tv[32 * w + r])
        code = new
        src = sv if r < 31 else sv_n
        sc = src[(r + 1) % 32]
    return np.array(cols), np.array(srows)


@pytest.mark.parametrize("W,lpt,nw,dmin,slen,tlen", [
    (128, 4, 1, -64, 300, 290),      # a warp per pair, ragged lengths
    (256, 8, 1, -100, 97, 250),      # slen not a multiple of 32
    (128, 4, 1, -420, 120, 640),     # dmax < 0: the band left of the
    (512, 4, 4, -700, 64, 600),      # main diagonal, T much longer
    (512, 8, 2, -256, 33, 40),       # one row past a block; T short
    (384, 8, 2, -10, 5, 300),        # rows of T before j = 0; dead lanes
])
def test_code_registers_follow_the_twins_letters(W, lpt, nw, dmin, slen,
                                                 tlen):
    """Each lane's column at row i is t[i - 1 + k - dmax] (the twin's
    t_idx = j - 1), or the pad column outside [0, tlen) and for a
    negative code; each row's S code is s[i - 1]."""
    A = 4
    rng = np.random.default_rng(slen + tlen)
    s = rng.integers(0, A, 320).astype(np.int8)
    t = rng.integers(0, A, 700).astype(np.int8)
    t[rng.random(700) < 0.05] = -1           # pads inside T
    dmax = dmin + W - 1
    cols, srows = window_model(s, t, slen, tlen, dmax, W, lpt, nw, A)
    k = np.arange(W)
    for i in range(1, slen + 1):
        want = [t_column(t, tlen, i - 1 + kk - dmax, A) for kk in k]
        assert np.array_equal(cols[i - 1][:W], want), i
        assert srows[i - 1] == s[i - 1]
    assert (cols == A).any() and (cols < A).any()


@pytest.mark.parametrize("A,subst", [(4, UNIT), (20, None)])
def test_padded_table_is_the_twins_substitution(A, subst):
    """The kernel's (A + 1) x (A + 1) table, read at (S row, T column),
    gives the twin's ``sub`` for every pair of codes, pads included:
    table[s, t] for letters, 0 for an S pad, NEG for a T pad."""
    rng = np.random.default_rng(A)
    if subst is None:
        subst = rng.integers(-4, 6, (A, A)).astype(np.float32)
    table = dp_row._table(np.asarray(subst, np.float32))
    A1 = A + 1
    tab = np.empty(A1 * A1, np.float32)
    for x in range(A1 * A1):                 # the kernel's fill loop
        r, c = divmod(x, A1)
        tab[x] = NEGF if c == A else (0.0 if r == A else table[r, c])
    for sc in range(-2, A):
        for tc in range(-2, A):
            base = table[sc, tc] if 0 <= sc < A and tc >= 0 else 0.0
            want = NEGF if tc < 0 else np.float32(base)
            row = sc if 0 <= sc < A else A
            col = tc if tc >= 0 else A
            assert tab[row * A1 + col] == want
