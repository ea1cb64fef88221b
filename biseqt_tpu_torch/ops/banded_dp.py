"""The banded-DP contract and the row-wavefront reference ("lax") engine.

The port's counterpart of :mod:`biseqt_tpu.ops.banded_dp`: ``NEG``,
:class:`ModeFlags`, :class:`DPResult`, the device rules every kernel
wrapper shares (:func:`resolve_device`, :func:`on_device`), and the
engine the JAX package runs with ``lax.scan``: :func:`banded_dp`,
:func:`full_dp`, the checkpointed :func:`full_dp_traceback` and the host
walk :func:`traceback_path`.

The engine is plain PyTorch on any device: a ``[B, W]`` state, a Python
loop over rows, the JAX package's float operations in its order, so
scores, end cells and direction bytes equal the reference's exactly.
On a card the loop's rows are replayed from CUDA graphs
(:func:`.steps.run_steps`), each row's index read from the device.

  * In banded mode lane ``k`` is the diagonal ``d = dmax - k``; at row
    ``i`` it holds cell ``(i, j = i - dmax + k)``.  Diag (i-1, j-1) is the
    same lane of the previous row, up (i-1, j) lane ``k+1``, left (i, j-1)
    lane ``k-1`` of the same row.  In full mode lane ``k`` is column j.
  * The within-row affine-gap chain is the closed form
    ``E[k] = ge*k + cummax_m(H_pre[m-1] + go + ge - ge*m)``: one prefix
    max per row (valid for ``go <= 0``, enforced).
  * Direction bytes (lax format, ``[B, LS, W]`` uint8, row r = DP row
    r + 1): bits 0-1 the H source (0 stop, 1 diag, 2 E, 3 F), bit 2
    E-extend, bit 3 F-extend.

It is the CPU oracle for the port's kernels and the engine of
``pw.Aligner(backend="lax")``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..profiling import count, host_copy
from .steps import put, run_steps

NEG = -1e30  # finite -inf; float32(NEG) is what the kernels carry

__all__ = [
    "ModeFlags", "DPResult", "NEG", "resolve_device", "on_device",
    "banded_dp", "full_dp", "full_dp_traceback", "traceback_path",
]


class ModeFlags(NamedTuple):
    """Static alignment-mode switches (the alntype family as predicates)."""
    free_start_edges: bool = False  # start anywhere on row 0 / column 0
    local_start: bool = False       # start anywhere (Smith-Waterman origin)
    free_end_edges: bool = False    # end anywhere on last row / last column
    local_end: bool = False         # end anywhere (max over all cells)


class DPResult(NamedTuple):
    score: torch.Tensor     # [B] best score per pair under the mode
    end_i: torch.Tensor     # [B] row of the optimum (i index, 0..LS)
    end_j: torch.Tensor     # [B] col of the optimum (j index, 0..LT)
    dirs: torch.Tensor      # direction bytes, or an empty tensor


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, with the index of the
    current CUDA device filled in for a bare ``"cuda"``.  Only the CPU
    and CUDA are supported.  Asked for CUDA where no card is present it
    raises: the port never falls back to the CPU."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r asks for a CUDA card and none is present; pass "
                "device=\"cpu\" to run the plain PyTorch versions"
                % str(device))
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(x, dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``.  A numpy array (or list)
    is copied there; a tensor must already live there, because a kernel
    wrapper never moves a caller's data between the card and the host."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError("tensor on %s passed with device=%s"
                             % (x.device, device))
        return x.to(dtype)
    x = np.asarray(x)
    if device.type == "cuda":
        # through pinned memory, not waited for: a copy from pageable
        # memory would first wait for all the work queued on the card
        x = np.array(x, order="C")
        count("bytes_to_card", x.nbytes)
        return torch.from_numpy(x).pin_memory().to(
            device, non_blocking=True).to(dtype)
    if not x.flags.writeable:     # a Sequence's frozen codes
        x = x.copy()
    return torch.as_tensor(x, device=device).to(dtype)


def _host(x) -> np.ndarray:
    return (host_copy(x).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


# ---------------------------------------------------------------------------
# the row update (one [B, W] row of H, F and direction bytes)
# ---------------------------------------------------------------------------

def shift_lanes(x, by: int, fill):
    """Shift along the lane (last) axis; vacated lanes get ``fill``.
    ``by > 0`` moves values toward higher lanes (lane k reads k - by)."""
    if by == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(by),), fill, dtype=x.dtype,
                     device=x.device)
    if by > 0:
        return torch.cat([pad, x[..., :-by]], dim=-1)
    return torch.cat([x[..., -by:], pad], dim=-1)


def prefix_max(x):
    """Inclusive prefix max along lanes."""
    return torch.cummax(x, dim=-1).values


def _row_update(H_prev, F_prev, sub_score, cell_valid, j_idx, go, ge, *,
                up_shift: int, diag_shift: int, local_start: bool,
                free_start_col: bool, want_dirs: bool):
    """One DP row; all arrays [B, W]; returns (H, F, dirs_u8 | None).

    ``sub_score`` may hold garbage where the diag predecessor is
    invalid (its NEG swamps it); ``cell_valid`` masks the cells
    (i, j) with 0 <= j <= LT of a valid row."""
    W = H_prev.shape[-1]
    karange = torch.arange(W, dtype=torch.float32, device=H_prev.device)

    diag_cand = shift_lanes(H_prev, diag_shift, NEG) + sub_score
    F_open = shift_lanes(H_prev, -up_shift, NEG) + (go + ge)
    F_ext = shift_lanes(F_prev, -up_shift, NEG) + ge
    F_new = torch.maximum(F_open, F_ext)

    H_pre = torch.maximum(diag_cand, F_new)
    if local_start:
        H_pre = torch.clamp_min(H_pre, 0.0)
    if free_start_col:
        H_pre = torch.where(j_idx == 0, torch.clamp_min(H_pre, 0.0), H_pre)
    H_pre = torch.where(cell_valid, H_pre, NEG)

    # E scan: E[k] = ge*k + cummax_m(A[m]), A[m] = H_pre[m-1] + go + ge*(1-m)
    A = shift_lanes(H_pre, 1, NEG) + (go + ge) - ge * karange
    P = prefix_max(A)
    E = P + ge * karange
    E = torch.where(cell_valid, E, NEG)

    H = torch.maximum(H_pre, E)
    H = torch.where(cell_valid, H, NEG)

    dirs = None
    if want_dirs:
        d = torch.where(H == diag_cand, 1, torch.where(H == E, 2, 3))
        if local_start:
            d = torch.where((H == 0.0) & (diag_cand < 0.0), 0, d)
        if free_start_col:
            d = torch.where((j_idx == 0) & (H == 0.0) & (F_new < 0.0), 0, d)
        e_ext = (P == shift_lanes(P, 1, NEG)).to(torch.int64)
        f_ext = (F_new == F_ext).to(torch.int64)
        dirs = torch.where(cell_valid, d + 4 * e_ext + 8 * f_ext, 0).to(
            torch.uint8)
    return H, F_new, dirs


def _subst_lookup(subst, s_codes, t_codes):
    """Per-cell substitution score ``subst[s, t]`` with both codes
    clipped into the alphabet (out-of-range cells are masked later).
    subst: [A, A] f32; s_codes [B, 1]; t_codes [B, W]."""
    A = subst.shape[0]
    return subst[s_codes.clamp(0, A - 1), t_codes.clamp(0, A - 1)]


def _init_row(j_idx, lt, go, ge, flags: ModeFlags):
    """H at conceptual row i=0 (alignment of empty origin prefix vs T[:j])."""
    valid = (j_idx >= 0) & (j_idx <= lt)
    jf = j_idx.to(torch.float32)
    gap = torch.where(j_idx > 0, go + ge * jf, 0.0)
    if flags.local_start or flags.free_start_edges:
        h0 = torch.zeros_like(jf)
    else:
        h0 = gap
    return torch.where(valid, h0, NEG)


def _check_gap_scores(go, ge):
    """The closed-form affine E scan assumes extending a gap never loses
    to closing and reopening it: go <= 0 and ge <= 0."""
    if not (float(go) <= 0 and float(ge) <= 0):
        raise ValueError(
            "affine gap scores must satisfy go <= 0 and ge <= 0 "
            "(got go=%r, ge=%r)" % (go, ge))


# ---------------------------------------------------------------------------
# the row sweep shared by the banded and the full-matrix engines
# ---------------------------------------------------------------------------

class _Sweep:
    """Inputs of one batched sweep on ``device``.  ``banded``: lane k of
    row i is column ``j = i - dmax + k``; otherwise lane k is column k
    (``dmax`` is then 0 and the row offset vanishes)."""

    def __init__(self, s_codes, t_codes, s_lens, t_lens, subst, go, ge,
                 flags, device, *, banded, W=None, dmin=None, w_eff=None):
        dev = self.device = resolve_device(device)
        _check_gap_scores(go, ge)
        s = on_device(s_codes, torch.int32, dev)
        t = on_device(t_codes, torch.int32, dev)
        B, LS = s.shape
        LT = t.shape[1]
        if t.shape[0] != B or LS < 1 or LT < 1:
            raise ValueError("s_codes / t_codes must be [B, LS] / [B, LT] "
                             "with LS, LT >= 1")
        i32 = lambda x: on_device(x, torch.int32, dev).reshape(B)
        self.s, self.B, self.LS, self.LT = s, B, LS, LT
        self.s_lens, self.t_lens = i32(s_lens), i32(t_lens)
        self.flags, self.banded = flags, banded
        # through on_device: a copy from pageable memory would wait for
        # the work queued on the card (the row route of extend_segments
        # keeps launches in flight)
        self.subst = on_device(np.asarray(subst, np.float32), torch.float32,
                               dev)
        self.go = on_device(np.float32(go), torch.float32, dev)
        self.ge = on_device(np.float32(ge), torch.float32, dev)
        if banded:
            self.W = int(W)
            self.dmax = i32(dmin) + (self.W - 1)
            self.w_eff = (torch.full((B,), self.W, dtype=torch.int32,
                                     device=dev)
                          if w_eff is None else i32(w_eff))
            # band frame: T2[b, y] = T[b, y - dmax_b], y in [0, LS + W)
            yy = torch.arange(LS + self.W, dtype=torch.int32,
                              device=dev)[None, :]
            src = yy - self.dmax[:, None]
            self.t2 = torch.where(
                (src >= 0) & (src < self.t_lens[:, None]),
                t.gather(1, src.clamp(0, LT - 1).long()), -1)
        else:
            self.W = LT + 1
            self.dmax = torch.zeros((B,), dtype=torch.int32, device=dev)
            self.w_eff = torch.full((B,), self.W, dtype=torch.int32,
                                    device=dev)
            # the t character of column j is T[j - 1]
            self.t_cols = torch.cat(
                [torch.full((B, 1), -1, dtype=torch.int32, device=dev), t],
                dim=1)
        self.karange = torch.arange(self.W, dtype=torch.int32,
                                    device=dev)[None, :]

    def j_of(self, i):
        """[B, W] column of each lane at row i (i an int or [B] tensor)."""
        if not self.banded:
            return self.karange.expand(self.B, self.W)
        i = i[:, None] if isinstance(i, torch.Tensor) else i
        return self.karange + (i - self.dmax[:, None])

    def lane_of(self, i, j):
        """[B] lane of column j at row i (out of [0, W) when off band)."""
        return j - i + self.dmax if self.banded else j

    def valid(self, j_idx):
        return ((j_idx >= 0) & (j_idx <= self.t_lens[:, None])
                & (self.karange < self.w_eff[:, None]))

    def init_row(self):
        H0 = _init_row(self.j_of(0), self.t_lens[:, None], self.go,
                       self.ge, self.flags)
        H0 = torch.where(self.karange < self.w_eff[:, None], H0, NEG)
        return H0, torch.full_like(H0, NEG)

    def row(self, H_prev, F_prev, i, with_dirs: bool):
        """Row i (1-based; an int, or a one-element int32 device tensor
        in a CUDA graph) from row i - 1; rows past a pair's length
        freeze.  Returns (H, F, H masked to valid cells, dirs|None)."""
        row_valid = (i <= self.s_lens)[:, None]
        j_idx = self.j_of(i)
        cell_valid = self.valid(j_idx) & row_valid
        if isinstance(i, int):
            s_char = self.s[:, min(i - 1, self.LS - 1)][:, None]
        else:
            s_char = self.s.index_select(1, i - 1)
        if not self.banded:
            t_win = self.t_cols
        elif isinstance(i, int):
            # window start i - 1 is the same for every pair
            t_win = self.t2[:, i - 1:i - 1 + self.W]
        else:
            t_win = self.t2.index_select(1, self.karange[0] + (i - 1))
        sub = _subst_lookup(self.subst, s_char, t_win)
        H, F, dirs = _row_update(
            H_prev, F_prev, sub, cell_valid, j_idx, self.go, self.ge,
            up_shift=1 if self.banded else 0,
            diag_shift=0 if self.banded else 1,
            local_start=self.flags.local_start,
            free_start_col=self.flags.free_start_edges,
            want_dirs=with_dirs)
        H = torch.where(row_valid, H, H_prev)
        F = torch.where(row_valid, F, F_prev)
        return H, F, torch.where(cell_valid, H, NEG), dirs


def _at(H, lane, W):
    """[B] values of H at per-pair lanes (NEG where off [0, W))."""
    val = H.gather(1, lane.clamp(0, W - 1).long()[:, None])[:, 0]
    return torch.where((lane >= 0) & (lane < W), val, NEG)


def _solve(sw: _Sweep, with_dirs: bool) -> DPResult:
    """The full sweep with the mode's trackers (rows 0..LS)."""
    flags, B, W, LS = sw.flags, sw.B, sw.W, sw.LS
    sl, tl = sw.s_lens, sw.t_lens
    H, F = sw.init_row()

    # row 0 (the init row) is part of the matrix: its cells can be
    # alignment ends, so the trackers are seeded from it
    H0m = torch.where(sw.valid(sw.j_of(0)), H, NEG)
    best = torch.full((B,), NEG, dtype=torch.float32, device=sw.device)
    bi = torch.zeros((B,), dtype=torch.int32, device=sw.device)
    bk = torch.zeros((B,), dtype=torch.int32, device=sw.device)
    if flags.local_end:
        best = H0m.max(dim=1).values
        bk = torch.argmax(H0m, dim=1).to(torch.int32)
    if flags.free_end_edges:
        kc0 = sw.lane_of(0, tl)
        colval0 = _at(H0m, kc0, W)
        b2 = colval0 > best
        best = torch.where(b2, colval0, best)
        bk = torch.where(b2, kc0.clamp(0, W - 1), bk)
        rm0 = H0m.max(dim=1).values
        ra0 = torch.argmax(H0m, dim=1).to(torch.int32)
        b3 = (sl == 0) & (rm0 > best)
        best = torch.where(b3, rm0, best)
        bk = torch.where(b3, ra0, bk)
    corner = torch.where(sl == 0, _at(H0m, sw.lane_of(0, tl), W), NEG)

    dirs = (torch.empty((B, LS, W), dtype=torch.uint8, device=sw.device)
            if with_dirs else None)
    # [LS, B, W] view: its entry r is row r + 1 of every pair's plane
    dirs_rows = dirs.transpose(0, 1) if with_dirs else None

    def upd(best, bi, bk, cand_val, cand_k, active, i):
        better = active & (cand_val > best)
        return (torch.where(better, cand_val, best),
                torch.where(better, i, bi),
                torch.where(better, cand_k.to(torch.int32), bk))

    def step(a, i_now, state):
        """Row ``i_now``: an int, or inside a CUDA graph a one-element
        int64 device tensor (``a``, its value, is unused)."""
        H, F, best, bi, bk, corner = state
        i = i_now if isinstance(i_now, int) else i_now.to(torch.int32)
        H, F, Hm, d = sw.row(H, F, i, with_dirs)
        if with_dirs:
            put(dirs_rows, i_now - 1, d)
        row_valid = i <= sl
        if flags.local_end:
            best, bi, bk = upd(best, bi, bk, Hm.max(dim=1).values,
                               torch.argmax(Hm, dim=1), row_valid, i)
        kcol = sw.lane_of(i, tl)
        if flags.free_end_edges:
            best, bi, bk = upd(best, bi, bk, _at(H, kcol, W), kcol,
                               row_valid, i)
            is_last = i == sl
            best, bi, bk = upd(
                best, bi, bk,
                torch.where(is_last, Hm.max(dim=1).values, NEG),
                torch.argmax(Hm, dim=1), is_last, i)
        # corner (i == LS, j == LT) for global / end-anchored modes
        corner = torch.where(i == sl, _at(H, kcol, W), corner)
        return H, F, best, bi, bk, corner

    H, F, best, bi, bk, corner = run_steps(
        step, (H, F, best, bi, bk, corner), range(1, LS + 1))

    if flags.local_end or flags.free_end_edges:
        score, ei, ek = best, bi, bk
    else:
        score, ei, ek = corner, sl, sw.lane_of(sl, tl)
    ej = ei - sw.dmax + ek if sw.banded else ek
    if dirs is None:
        dirs = torch.empty((0,), dtype=torch.uint8, device=sw.device)
    return DPResult(score=score, end_i=ei.to(torch.int32),
                    end_j=ej.to(torch.int32), dirs=dirs)


def banded_dp(s_codes, t_codes, s_lens, t_lens, dmin, *, W: int, subst,
              go, ge, flags: ModeFlags, with_dirs: bool = False,
              w_eff=None, device="cuda") -> DPResult:
    """Batched banded affine-gap DP (the reference engine).

    Args (numpy arrays, or tensors already on ``device``):
        s_codes: int [B, LS] origin rows (PAD tail ok).
        t_codes: int [B, LT] mutate rows.
        s_lens, t_lens: int32 [B].
        dmin: int32 [B] per-pair band lower diagonal (d = i - j); the
            band covers d in [dmin, dmin + W - 1], and with ``w_eff``
            only its top ``w_eff`` diagonals (lanes k >= w_eff are dead).
        subst: [A, A] float substitution scores.
        go, ge: gap open / extend scores (both <= 0).
        flags: ModeFlags.
        with_dirs: also return direction bytes ``[B, LS, W]``.

    Returns :class:`DPResult`.
    """
    sw = _Sweep(s_codes, t_codes, s_lens, t_lens, subst, go, ge, flags,
                device, banded=True, W=W, dmin=dmin, w_eff=w_eff)
    return _solve(sw, with_dirs)


def full_dp(s_codes, t_codes, s_lens, t_lens, *, subst, go, ge,
            flags: ModeFlags, with_dirs: bool = False,
            device="cuda") -> DPResult:
    """Batched full-matrix affine-gap DP (lane k = column j, width
    LT + 1); the contract of :func:`banded_dp` otherwise."""
    sw = _Sweep(s_codes, t_codes, s_lens, t_lens, subst, go, ge, flags,
                device, banded=False)
    return _solve(sw, with_dirs)


# ---------------------------------------------------------------------------
# checkpointed re-solve traceback (STD_MODE memory fallback)
# ---------------------------------------------------------------------------

def full_dp_traceback(s_codes, t_codes, s_lens, t_lens, *, subst, go, ge,
                      flags: ModeFlags, end_i, end_j,
                      block_rows: int = 512, device="cuda"):
    """Transcripts for full-matrix alignments in O(block_rows * LT)
    direction memory instead of O(LS * LT).

    One score-shaped forward pass stores the (H, F) row state every
    ``block_rows`` rows; the walk then re-solves one block at a time
    with direction bytes and chases pointers backwards through it.
    Blocks are visited from the last to the first, and each block is
    re-solved once for all the pairs whose walk is inside it (walks
    pause at a block's lower edge; E runs never cross blocks).

    ``end_i`` / ``end_j`` come from the score-only pass.  Returns a list
    of ``(transcript, origin_start, mutate_start)`` per pair.
    """
    sw = _Sweep(s_codes, t_codes, s_lens, t_lens, subst, go, ge, flags,
                device, banded=False)
    B, LS, W = sw.B, sw.LS, sw.W
    K = int(block_rows)
    n_blocks = max((LS + K - 1) // K, 1)
    H, F = sw.init_row()
    ckpts = [(H, F)]
    for k in range(n_blocks - 1):
        for i in range(k * K + 1, (k + 1) * K + 1):
            H, F, _, _ = sw.row(H, F, i, False)
        ckpts.append((H, F))

    s_np, t_np = _host(s_codes), _host(t_codes)
    cur_i = [int(x) for x in _host(end_i)]
    cur_j = [int(x) for x in _host(end_j)]
    states = ["H"] * B
    done = [False] * B
    opss = [[] for _ in range(B)]
    for k in range(n_blocks - 1, -1, -1):
        needs = [b for b in range(B)
                 if not done[b] and cur_i[b] >= 1 and (cur_i[b] - 1) // K == k]
        if not needs:
            continue
        H, F = ckpts[k]
        rows = []
        for i in range(k * K + 1, (k + 1) * K + 1):
            if i > LS:
                break
            H, F, _, d = sw.row(H, F, i, True)
            rows.append(d)
        dirs_k = torch.stack(rows, dim=1).cpu().numpy()
        for b in needs:
            i, j, state = cur_i[b], cur_j[b], states[b]
            ops = opss[b]

            def byte_at(i, j):
                if j < 0 or j >= W or i < 1:
                    raise ValueError(
                        "traceback left the matrix at (i=%d, j=%d)" % (i, j))
                return int(dirs_k[b, (i - 1) - k * K, j])

            while not done[b] and i >= 1 and (i - 1) // K == k:
                if state == "H":
                    if j == 0:
                        done[b] = True
                        break
                    bt = byte_at(i, j)
                    src = bt & 3
                    if src == 0:
                        done[b] = True
                        break
                    if src == 1:
                        ops.append("M" if s_np[b, i - 1] == t_np[b, j - 1]
                                   else "S")
                        i -= 1
                        j -= 1
                    elif src == 2:
                        state = "E"
                    else:
                        state = "F"
                elif state == "E":
                    bt = byte_at(i, j)
                    ops.append("I")
                    j -= 1
                    if not (bt >> 2) & 1 or j == 0:
                        state = "H"
                else:
                    bt = byte_at(i, j)
                    ops.append("D")
                    i -= 1
                    if not (bt >> 3) & 1 or i == 0:
                        state = "H"
            cur_i[b], cur_j[b], states[b] = i, j, state

    out = []
    for b in range(B):
        i, j, ops = cur_i[b], cur_j[b], opss[b]
        if not (flags.local_start or flags.free_start_edges):
            ops.extend("I" * j)
            ops.extend("D" * i)
            i = 0
            j = 0
        out.append(("".join(reversed(ops)), i, j))
    return out


# ---------------------------------------------------------------------------
# host-side traceback (numpy pointer chase)
# ---------------------------------------------------------------------------

def traceback_path(dirs, s_codes, t_codes, end_i, end_j, *, banded: bool,
                   dmax: int = 0, flags: ModeFlags = ModeFlags()):
    """Walk direction bytes from (end_i, end_j) back to the origin.

    Mirrors ``pwlib — dptable_traceback``: returns
    ``(transcript_str, origin_start, mutate_start)`` with ops over MSID.
    ``dirs``: [LS, W] uint8 for one pair (row r holds DP row i = r + 1).
    """
    dirs = _host(dirs)
    W = dirs.shape[1]
    s = _host(s_codes)
    t = _host(t_codes)
    i, j = int(end_i), int(end_j)

    def byte_at(i, j):
        k = (j - i + dmax) if banded else j
        if k < 0 or k >= W or i < 1:
            # a negative index would silently walk the wrong lane
            raise ValueError(
                "traceback left the direction plane at (i=%d, j=%d) — "
                "end cell outside the band or wrong dmax" % (i, j))
        return int(dirs[i - 1, k])

    ops = []
    state = "H"
    while True:
        if state == "H":
            if i == 0 or j == 0:
                break
            b = byte_at(i, j)
            src = b & 3
            if src == 0:  # fresh local/free start
                break
            if src == 1:
                ops.append("M" if s[i - 1] == t[j - 1] else "S")
                i -= 1
                j -= 1
            elif src == 2:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            b = byte_at(i, j)
            ops.append("I")
            j -= 1
            if not (b >> 2) & 1 or j == 0:
                state = "H"
        else:  # F
            b = byte_at(i, j)
            ops.append("D")
            i -= 1
            if not (b >> 3) & 1 or i == 0:
                state = "H"
    # boundary: for corner-anchored starts, consume the remaining prefix
    if not (flags.local_start or flags.free_start_edges):
        ops.extend("I" * j)
        ops.extend("D" * i)
        i = 0
        j = 0
    return "".join(reversed(ops)), i, j
