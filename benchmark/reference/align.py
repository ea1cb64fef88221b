"""Plain banded local alignment with affine gaps: the benchmark's reference.

Plain PyTorch and NumPy; it imports nothing of the program under test.
Scoring (the reference biseqt ``pwlib`` contract as the library serves
it): a column of two letters scores ``subst[s, t]``; a run of n gap
letters scores ``go + n * ge``; local mode, so an alignment starts and
ends anywhere and the empty alignment scores 0.  Cell (i, j) sits after
i letters of S and j of T, on diagonal ``d = i - j``; an alignment of a
row stays inside the row's cutouts and on the diagonals of its band
(:func:`.cut.band`).

:func:`local_scores` is the textbook Gotoh recurrence swept row by row
and vectorised over pairs and band lanes, in the precision it is given:

    F(i, j) = max(H(i-1, j) + go + ge, F(i-1, j) + ge)
    E(i, j) = max(H(i, j-1) + go + ge, E(i, j-1) + ge)
    H(i, j) = max(0, H(i-1, j-1) + subst[s_i, t_j], E(i, j), F(i, j))

with H = 0 on the cutouts' first row and column, and the score the
largest H.  Lane x of row i is the cell (i, j = i - hi + x).  E along a
row is one running maximum: E(i, x) = go + ge x + max over y < x of
(H'(i, y) - ge y), where H' is H without its E term (an E path that
rests on an earlier E opens no better than that E's own opening, since
go <= 0).  Every band cell takes the floor at 0, also the cells outside
the cutouts, whose letters are a sentinel that no move through them can
profit from: a cell before the cutouts scores 0, as the first row and
column do, and a cell past them scores less than the cell it came from,
so neither changes the largest H inside.

:func:`rescore` reads an MSID transcript against the letters it claims:
its score, and whether every cell it visits lies in the row's band and
cutouts and its M / S columns say truly whether the letters agree.
"""

import numpy as np
import torch

# far below any score a real cell reaches, and exact in bfloat16
NEG = -2.0 ** 30
# the sentinel letter's score against anything
SENTINEL = -2.0 ** 20
# rows a CUDA graph replays at once on a card
GRAPH_ROWS = 256


def local_scores(s_list, t_list, bands, subst, go, ge, *,
                 dtype=torch.float32, device="cpu"):
    """The optimal local alignment score of each pair inside its band.

    ``s_list`` / ``t_list``: the pairs' cutouts, int8 letter codes;
    ``bands``: ``(lo, hi)`` diagonals of each pair (d = i - j of the
    cutouts).  The recurrence runs in ``dtype`` on ``device`` (on a card
    its rows replay from CUDA graphs).  Returns float64 numpy scores as
    ``dtype`` computed them."""
    P = len(s_list)
    if P == 0:
        return np.zeros((0,), np.float64)
    dev = torch.device(device)
    subst = np.asarray(subst, np.float64)
    A = subst.shape[0]
    table = np.full((A + 1, A + 1), SENTINEL)
    table[:A, :A] = subst
    table = torch.tensor(table.reshape(-1), dtype=dtype, device=dev)
    lo = np.array([b[0] for b in bands], np.int64)
    hi = np.array([b[1] for b in bands], np.int64)
    w = hi - lo + 1
    wmax = int(w.max())
    LS = max(len(s) for s in s_list)
    # row i reads S letter i - 1 and T letters j - 1 = i - hi + x - 1
    pad_l = int(max(hi.max(), 0)) + 1
    LT = pad_l + max(LS - int(hi.min()) + wmax,
                     max(len(t) for t in t_list)) + 1
    S = np.full((P, LS + 1), A, np.int64)
    T = np.full((P, LT), A, np.int64)
    for p in range(P):
        S[p, :len(s_list[p])] = s_list[p]
        T[p, pad_l:pad_l + len(t_list[p])] = t_list[p]
    S = torch.as_tensor(S, device=dev)
    T = torch.as_tensor(T, device=dev)
    x = torch.arange(wmax, device=dev)[None, :]
    # T index of lane x in row i: base + i
    base = (x - torch.as_tensor(hi, device=dev)[:, None] - 1 + pad_l)
    c = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    lane = torch.where(x < torch.as_tensor(w, device=dev)[:, None],
                       c(0.0), c(NEG))
    zero, goe, gef = c(0.0), c(go + ge), c(ge)
    x_ge = x.to(dtype) * gef
    # E's constant and the lanes' offsets, so a row is few operations
    e_off = x_ge + goe - gef
    state = dict(
        i=torch.zeros((1, 1), dtype=torch.int64, device=dev),
        H=torch.zeros((P, wmax), dtype=dtype, device=dev) + lane,
        F=torch.full((P, wmax), NEG, dtype=dtype, device=dev),
        best=torch.zeros((P, wmax), dtype=dtype, device=dev))
    neg_col = torch.full((P, 1), NEG, dtype=dtype, device=dev)

    def row():
        """Row i + 1 from row i, in place."""
        st = state
        st["i"] += 1
        sc = torch.gather(S, 1, (st["i"] - 1).expand(P, 1))
        tc = torch.gather(T, 1, base + st["i"])
        H, F = st["H"], st["F"]
        diag = H + table[sc * (A + 1) + tc]
        # (i-1, j) is lane x + 1 of the previous row
        Fn = torch.cat([torch.maximum(H[:, 1:] + goe, F[:, 1:] + gef),
                        neg_col], 1)
        H0 = torch.maximum(torch.maximum(diag, Fn), zero)
        # E moves to higher lanes: the band's lanes [0, w) hear only
        # their own; the lanes past it are masked once E is in
        run = torch.cummax(H0 - x_ge, dim=1).values
        E = torch.cat([neg_col, run[:, :-1]], 1) + e_off
        Hn = torch.maximum(H0, E) + lane
        H.copy_(Hn)
        F.copy_(Fn)
        torch.maximum(st["best"], Hn, out=st["best"])

    rows = LS
    if dev.type == "cuda" and rows > 2 * GRAPH_ROWS:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):     # warm-up rows, real ones
                row()
        torch.cuda.current_stream(dev).wait_stream(side)
        rows -= 3
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_ROWS):
                row()
        # capturing ran no row
        for _ in range(rows // GRAPH_ROWS):
            graph.replay()
        rows %= GRAPH_ROWS
    for _ in range(rows):
        row()
    return state["best"].max(dim=1).values.double().cpu().numpy()


def rescore(ops, start_i, start_j, s_arr, t_arr, cut, band, subst, go, ge):
    """``(score, ok)`` of an MSID transcript that starts at cell
    ``(start_i, start_j)`` of the whole S and T: ``ok`` is False unless
    every cell it visits lies in the cutouts of ``cut`` and on the
    diagonals ``band`` of them, and its M / S columns are matches /
    mismatches of the letters there."""
    if not ops:
        return 0.0, True
    o = np.frombuffer(ops.encode("ascii"), np.uint8)
    if not np.isin(o, np.frombuffer(b"MSID", np.uint8)).all():
        return 0.0, False
    diag = (o == ord("M")) | (o == ord("S"))
    ins, dele = o == ord("I"), o == ord("D")
    adv_i = (diag | dele).astype(np.int64)
    adv_j = (diag | ins).astype(np.int64)
    ci = start_i + np.concatenate([[0], np.cumsum(adv_i)])
    cj = start_j + np.concatenate([[0], np.cumsum(adv_j)])
    i_lo, i_hi, j_lo, j_hi = cut[:4]
    d = (ci - i_lo) - (cj - j_lo)
    if not ((ci >= i_lo).all() and (ci <= i_hi).all() and (cj >= j_lo).all()
            and (cj <= j_hi).all() and (d >= band[0]).all()
            and (d <= band[1]).all()):
        return 0.0, False
    # the letters of each column: the cell before it
    li, lj = ci[:-1][diag], cj[:-1][diag]
    cs, ct = s_arr[li], t_arr[lj]
    if not np.array_equal(cs == ct, o[diag] == ord("M")):
        return 0.0, False
    prev = np.concatenate([[0], o[:-1]])
    opens = int((ins & (prev != ord("I"))).sum()
                + (dele & (prev != ord("D"))).sum())
    subst = np.asarray(subst, np.float64)
    score = (subst[cs, ct].sum() + ge * int(ins.sum() + dele.sum())
             + go * opens)
    return float(score), True
