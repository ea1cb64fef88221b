"""Row-form banded affine-gap DP: CUDA kernel + plain twin.

The port of :mod:`biseqt_tpu.ops.pallas_dp` (TPU kernel ``_kernel``,
public ``banded_dp_pallas``), the engine of
``pw.Aligner(backend="pallas_row")``.  Lane ``k`` of a row is the
diagonal ``d = dmax - k`` (``dmax = dmin + W - 1``); row ``i`` holds the
cells ``(i, j = i - dmax + k)``.  Lanes ``k >= w_eff`` are dead, so the
band is the top ``w_eff`` diagonals.  The contract is
``banded_dp_pallas``'s:

* ``score`` f32 [B]; with ``with_dirs`` the end cell of the optimum and
  the direction bytes ``[B, LS, W]`` uint8 in the lax engine's format
  (row r = DP row r + 1; bits 0-1 H source, bit 2 E-extend, bit 3
  F-extend; zero outside the matrix, the live band and the pair's
  rows);
* a score-only solve in a local or overlap mode reports end cells
  ``-1`` (it does not track them); global modes report the corner.

Both engines below compute what the TPU kernel computes, which is not
quite the lax engine's recipe: validity comes from poisoning the
substitution score at T PAD (``t < 0 -> NEG``) instead of a cell mask,
H freezes past ``s_len`` but F does not, ``local_start`` floors every
lane (also those with ``j < 0``), dead lanes are masked after the E
merge, and the trackers take a strict ``>`` per row with the lowest
lane on ties (order local, column, last row).  Constants are formed as
the TPU kernel forms them (``go + ge`` summed in double, then
``cgek = (go + ge) - ge * k``, ``P = shr(H_pre, 1) + cgek``,
``E = P + ge * k``), because direction bits come from float equality
tests.

:func:`banded_dp_row` launches the CUDA kernel (``csrc/dp_row.cu``) on
CUDA, in the geometry :func:`plan` picks from the batch, and runs the
plain PyTorch twin :func:`banded_dp_row_reference` on the CPU.  Unlike
the JAX wrapper, the alphabet size defaults to the substitution
matrix's (the JAX wrapper defaults to 4, and its ``Aligner`` never
passes it, so a 20-letter matrix raises there).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..profiling import count
from .banded_dp import (NEG, DPResult, ModeFlags, on_device, resolve_device,
                        shift_lanes)

__all__ = ["banded_dp_row", "banded_dp_row_reference", "plan", "sm_count",
           "clusters", "Geometry", "MAX_W", "MAX_A"]

# the widest band the kernel takes: above 4096 lanes a pair is a
# thread-block cluster of at most 16 blocks of 512 threads x 8 lanes;
# above PORTABLE_W (8 blocks, the portable cluster size) the wrapper
# first asks the card whether it holds such a cluster
MAX_W = 65536
PORTABLE_W = 32768
MAX_A = 127       # letter codes are int8
# the routes that take any W
WIDE_ROUTES = ("Aligner(backend=\"native\") or \"lax\", or"
               " parallel.banded_dp_band_sharded")

# The kernel's instances (csrc/dp_row.cu): lanes a thread owns, for a
# warp per pair (W = 32 * LPT, one warp a block), for a block per pair
# (the fewest warps that cover W, at most MAX_BLOCK_THREADS threads) and
# for a cluster of such blocks per pair (CLUSTER_LPT lanes a thread, at
# most MAX_CLUSTER blocks).
WARP_LPT = (4, 8)
BLOCK_LPT = (4, 8)
MAX_BLOCK_THREADS = 512
CLUSTER_LPT = 8
MAX_CLUSTER = 16

_NEGF = np.float32(NEG)


class Geometry(NamedTuple):
    """A launch of the kernel: ``lpt`` consecutive lanes a thread, a warp
    per pair (one a block), a block per pair, or a cluster of ``cluster``
    blocks per pair."""

    lpt: int
    warp_per_pair: bool
    cluster: int = 1

    def threads(self, W: int) -> int:
        """Threads a block: one warp, or the fewest whole warps that cover
        the block's share of W (lanes past W dead)."""
        if self.warp_per_pair:
            return 32
        warps = -(-W // (32 * self.lpt))
        return -(-warps // self.cluster) * 32

    def check(self, W: int) -> None:
        """Raise unless the kernel has this instance for W lanes."""
        if self.warp_per_pair:
            ok = (self.lpt in WARP_LPT and W == 32 * self.lpt
                  and self.cluster == 1)
        elif self.cluster > 1:
            ok = (self.lpt == CLUSTER_LPT and self.cluster <= MAX_CLUSTER
                  and self.threads(W) <= MAX_BLOCK_THREADS)
        else:
            ok = (self.lpt in BLOCK_LPT and self.cluster == 1
                  and self.threads(W) <= MAX_BLOCK_THREADS)
        if not ok:
            raise ValueError("the kernel has no instance %r for W %d"
                             % (self, W))


def plan(B: int, W: int, with_dirs: bool = False, *, sms: int) -> Geometry:
    """The kernel's geometry for ``B`` pairs of width ``W`` on a card of
    ``sms`` streaming multiprocessors.  Where a warp can own the whole row
    (W 128 or 256: 4 or 8 lanes a thread) it does, whatever the batch: no
    block barrier in the row loop.  Wider bands take a block per pair,
    one barrier a row, 8 lanes a thread (fewest warps), except with
    directions on fewer pairs than SMs: there 4 (8 a thread issue the
    longer directions code on too few schedulers).  Above 4096 lanes a
    pair takes the fewest blocks of at most 512 threads x 8 lanes, as a
    cluster."""
    if W % 32 == 0 and W // 32 in WARP_LPT:
        return Geometry(W // 32, True)
    if W > CLUSTER_LPT * MAX_BLOCK_THREADS:
        per_block = CLUSTER_LPT * MAX_BLOCK_THREADS
        return Geometry(CLUSTER_LPT, False, -(-W // per_block))
    fits4 = W <= 4 * MAX_BLOCK_THREADS
    return Geometry(4 if with_dirs and B < sms and fits4 else 8, False)


def _table(subst: np.ndarray) -> np.ndarray:
    """The substitution table both engines read.  Where the reference
    takes its uniform match / mismatch path (one value on the diagonal
    and one off it, by ``np.allclose``), its two values fill the table,
    so a nearly uniform matrix scores as it does there."""
    A = subst.shape[0]
    eye = np.eye(A, dtype=bool)
    diag, off = np.diag(subst), subst[~eye]
    if np.allclose(diag, diag[0]) and (off.size == 0
                                       or np.allclose(off, off[0])):
        mm = off[0] if off.size else np.float32(0)
        return np.where(eye, diag[0], mm).astype(np.float32)
    return subst


def _prepare(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, *, W, subst,
             go, ge, A, device):
    """Check the inputs and derive what both engines use."""
    if W % 128 or W < 128:
        raise ValueError("W must be a positive multiple of 128, got %d" % W)
    if not (go <= 0 and ge <= 0):
        raise ValueError("the kernel requires nonpositive gap scores")
    subst = np.asarray(subst, np.float32)
    if subst.ndim != 2 or subst.shape[0] != subst.shape[1]:
        raise ValueError("subst must be square, got %s" % (subst.shape,))
    if A is None:
        A = subst.shape[0]
    if A != subst.shape[0]:
        raise ValueError("A = %d but subst is %s" % (A, subst.shape))
    if A > MAX_A:
        raise ValueError("alphabets above %d letters do not fit the int8"
                         " letter codes" % MAX_A)
    s_codes = on_device(s_codes, torch.int8, device)
    t_codes = on_device(t_codes, torch.int8, device)
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    if B == 0 or t_codes.shape[0] != B or LS < 1 or LT < 1:
        raise ValueError("s_codes / t_codes must be [B, LS] / [B, LT] with "
                         "B, LS, LT >= 1 (pad empty sequences)")
    i32 = lambda x: on_device(x, torch.int32, device).reshape(B)
    s_lens, t_lens, dmin = i32(s_lens), i32(t_lens), i32(dmin)
    w_eff = (torch.full((B,), W, dtype=torch.int32, device=device)
             if w_eff is None else i32(w_eff))
    if (int(s_lens.min()) < 0 or int(s_lens.max()) > LS
            or int(t_lens.min()) < 0 or int(t_lens.max()) > LT):
        raise ValueError("sequence lengths outside [0, LS] / [0, LT]")
    # the kernel indexes its shared-memory table with the codes
    if int(s_codes.max()) >= A or int(t_codes.max()) >= A:
        raise ValueError("letter codes must lie below the alphabet size %d"
                         % A)
    return dict(
        B=B, LS=LS, LT=LT, W=W, A=A,
        s_codes=s_codes.contiguous(), t_codes=t_codes.contiguous(),
        s_lens=s_lens.contiguous(), t_lens=t_lens.contiguous(),
        dmax=(dmin + (W - 1)).contiguous(), w_eff=w_eff.contiguous(),
        table=torch.as_tensor(_table(subst), device=device),
        go=np.float32(go), ge=np.float32(ge),
        # the reference adds go + ge as Python floats (double), then
        # rounds once to f32
        gg=np.float32(float(go) + float(ge)),
    )


def _sweep_plain(g, flags: ModeFlags, with_dirs: bool):
    """The plain PyTorch engine: one vectorised [B, W] row update per
    row, in the TPU kernel's order of float operations and with its
    sequential per-row trackers.  Returns ``(score, ei, ek, dirs)``."""
    dev = g["s_codes"].device
    B, LS, LT, W, A = g["B"], g["LS"], g["LT"], g["W"], g["A"]
    f32 = lambda v: torch.tensor(np.float32(v), device=dev)
    NEGT, ZERO = f32(_NEGF), f32(0.0)
    go, ge, gg = f32(g["go"]), f32(g["ge"]), f32(g["gg"])
    k = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    kf = k.to(torch.float32)
    gek = ge * kf
    cgek = gg - gek
    col = lambda x: x[:, None]
    dmax, slen, tlen = col(g["dmax"]), col(g["s_lens"]), col(g["t_lens"])
    lane_ok = k < col(g["w_eff"])
    s = g["s_codes"].to(torch.int64)
    t = g["t_codes"].to(torch.int64)
    table = g["table"]
    shr1 = lambda x: shift_lanes(x, 1, float(_NEGF))     # lane k <- k - 1
    shl1 = lambda x: shift_lanes(x, -1, float(_NEGF))    # lane k <- k + 1
    track_local, track_col = flags.local_end, flags.free_end_edges

    # init row (i = 0)
    j0 = k - dmax
    valid0 = (j0 >= 0) & (j0 <= tlen) & lane_ok
    if flags.local_start or flags.free_start_edges:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=dev)
    else:
        h0 = torch.where(j0 > 0, go + ge * j0.to(torch.float32), ZERO)
    H = torch.where(valid0, h0, NEGT)
    F = torch.full((B, W), float(_NEGF), device=dev)
    # row 0 can hold alignment ends: the trackers are seeded from it
    if track_local:
        best_vec = H
    elif track_col:
        best_vec = torch.maximum(torch.where(k == tlen + dmax, H, NEGT),
                                 torch.where(slen == 0, H, NEGT))
    else:
        best_vec = torch.full((B, W), float(_NEGF), device=dev)
    best_sc = best_vec.max(dim=1, keepdim=True).values
    bi = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    bk = torch.argmax(best_vec, dim=1, keepdim=True).to(torch.int32)
    dirs = (torch.zeros((B, LS, W), dtype=torch.uint8, device=dev)
            if with_dirs else None)

    def track(better, val, i, kk):
        nonlocal best_sc, bi, bk
        bi = torch.where(better, i, bi)
        bk = torch.where(better, kk.to(torch.int32), bk)
        best_sc = torch.where(better, val, best_sc)

    for i in range(1, LS + 1):
        j = k + (i - dmax)
        t_idx = j - 1
        tc = torch.where((t_idx >= 0) & (t_idx < tlen),
                         t.gather(1, t_idx.clamp(0, LT - 1).long()), -1)
        sc = s[:, i - 1:i]
        base = torch.where((sc >= 0) & (sc < A),
                           table[sc.clamp(0, A - 1), tc.clamp(0, A - 1)],
                           ZERO)
        sub = torch.where(tc < 0, NEGT, base)

        diag = H + sub
        if with_dirs:
            F_ext = shl1(F) + ge
            F = torch.maximum(shl1(H + go) + ge, F_ext)
        else:
            F = shl1(torch.maximum(H + go, F)) + ge
        H_pre = torch.maximum(diag, F)
        if flags.local_start:
            H_pre = torch.maximum(H_pre, ZERO)
        if flags.free_start_edges:
            H_pre = torch.where(j == 0, torch.maximum(H_pre, ZERO), H_pre)
        P = torch.cummax(shr1(H_pre) + cgek, dim=1).values
        E = P + gek
        # dead lanes are masked after the E merge
        H_new = torch.where(lane_ok, torch.maximum(H_pre, E), NEGT)
        row_ok = i <= slen
        if with_dirs:
            d = torch.where(H_new == diag, 1, torch.where(H_new == E, 2, 3))
            if flags.local_start:
                d = torch.where((H_new == 0.0) & (diag < 0.0), 0, d)
            if flags.free_start_edges:
                d = torch.where((j == 0) & (H_new == 0.0) & (F < 0.0), 0, d)
            byte = d + 4 * (P == shr1(P)) + 8 * (F == F_ext)
            cell_ok = (j >= 0) & (j <= tlen) & lane_ok & row_ok
            dirs[:, i - 1] = torch.where(cell_ok, byte, 0).to(torch.uint8)
        # freeze H (not F) past each pair's length
        H = torch.where(row_ok, H_new, H)

        if with_dirs and (track_local or track_col):
            masked = torch.where(lane_ok & (j >= 0) & (j <= tlen), H_new,
                                 NEGT)
            rowmax = masked.max(dim=1, keepdim=True).values
            rowarg = torch.argmax(masked, dim=1, keepdim=True)
        if track_local:
            best_vec = torch.maximum(best_vec, H)
            if with_dirs:
                track(row_ok & (rowmax > best_sc), rowmax, i, rowarg)
        if track_col:
            kcol = tlen - i + dmax
            colvec = torch.where((k == kcol) & row_ok, H, NEGT)
            best_vec = torch.maximum(best_vec, colvec)
            if with_dirs:
                colval = colvec.max(dim=1, keepdim=True).values
                track(colval > best_sc, colval, i, kcol)
                track((i == slen) & (rowmax > best_sc), rowmax, i, rowarg)

    # H holds each pair's last real row
    kcorner = tlen - slen + dmax
    corner = torch.where((k == kcorner) & lane_ok, H, NEGT).max(dim=1).values
    if track_col:
        lastrow = torch.where(lane_ok, H, NEGT).max(dim=1).values
        score = torch.maximum(best_vec.max(dim=1).values, lastrow)
    elif track_local:
        score = best_vec.max(dim=1).values
    else:
        score = corner
    if track_local or track_col:
        if with_dirs:
            ei, ek = bi[:, 0], bk[:, 0]
        else:
            ei = torch.full((B,), -1, dtype=torch.int32, device=dev)
            ek = torch.zeros((B,), dtype=torch.int32, device=dev)
    else:
        ei, ek = g["s_lens"], kcorner[:, 0]
    return score, ei, ek, dirs


def _sweep_cuda(g, flags: ModeFlags, with_dirs: bool, geometry=None):
    """Launch ``csrc/dp_row.cu`` on the current stream in ``geometry``
    (default :func:`plan`); same outputs as :func:`_sweep_plain`."""
    from .. import _build
    from ..native import _flags_of

    B, LS, W = g["B"], g["LS"], g["W"]
    if W > MAX_W:
        raise ValueError(
            "the kernel takes bands of up to MAX_W = %d lanes (a cluster of"
            " 16 blocks), got W %d; wider bands run on %s"
            % (MAX_W, W, WIDE_ROUTES))
    dev = g["s_codes"].device
    if W > PORTABLE_W and clusters(W, g["A"], with_dirs, dev) < 1:
        raise ValueError(
            "W %d needs a cluster of %d blocks, which this card cannot hold;"
            " it runs up to PORTABLE_W = %d lanes, wider bands on %s"
            % (W, plan(1, W, sms=1).cluster, PORTABLE_W, WIDE_ROUTES))
    geo = (plan(B, W, with_dirs, sms=sm_count(dev)) if geometry is None
           else geometry)
    geo.check(W)
    lib = _build.load("dp_row", _declare)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    ei = torch.empty((B,), dtype=torch.int32, device=dev)
    ek = torch.empty_like(ei)
    dirs = (torch.zeros((B, LS, W), dtype=torch.uint8, device=dev)
            if with_dirs else None)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr() if x is not None else 0)
    f = ctypes.c_float
    rc = lib.bst_dp_row(
        ptr(g["s_codes"]), ptr(g["t_codes"]), ptr(g["s_lens"]),
        ptr(g["t_lens"]), ptr(g["dmax"]), ptr(g["w_eff"]),
        ptr(g["table"]), g["A"], B, LS, g["LT"], W, _flags_of(flags),
        f(g["go"]), f(g["ge"]), f(g["gg"]),
        ptr(score), ptr(ei), ptr(ek), ptr(dirs), int(with_dirs),
        geo.lpt, int(geo.warp_per_pair), geo.cluster, dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(lib, rc, "dp_row launch")
    count("launches.dp_row")
    return score, ei, ek, dirs


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (the planner's
    measure of a batch that fills the card)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def clusters(W: int, A: int = 4, with_dirs: bool = True, device="cuda"):
    """How many clusters of :func:`plan`'s blocks for a pair of ``W``
    lanes (above 4096) the card ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot run one)."""
    from .. import _build

    device = resolve_device(device)
    lib = _build.load("dp_row", _declare)
    geo = plan(1, W, with_dirs, sms=1)
    rc = lib.bst_dp_row_clusters(W, A, int(with_dirs), geo.cluster,
                                 device.index or 0)
    _build.check(lib, -rc if rc < 0 else 0, "dp_row cluster query")
    return rc


def _declare(lib):
    lib.bst_dp_row_clusters.restype = ctypes.c_int
    lib.bst_dp_row_clusters.argtypes = [ctypes.c_int] * 5
    lib.bst_dp_row.restype = ctypes.c_int
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bst_dp_row.argtypes = [
        v, v, v, v, v, v,               # s, t, s_lens, t_lens, dmax, w_eff
        v, i,                           # table, A
        i, i, i, i, i,                  # B, LS, LT, W, flags
        f, f, f,                        # go, ge, go + ge
        v, v, v, v, i,                  # score, ei, ek, dirs, with_dirs
        i, i, i,                        # lpt, warp_per_pair, cluster
        i, v,                           # device, stream
    ]


def _run(engine, s_codes, t_codes, s_lens, t_lens, dmin, W, subst, go, ge,
         flags, w_eff, A, with_dirs, device, **engine_kw):
    g = _prepare(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, W=W,
                 subst=subst, go=go, ge=ge, A=A, device=device)
    score, ei, ek, dirs = engine(g, flags, with_dirs, **engine_kw)
    ej = torch.where(ei < 0, -1, ei - g["dmax"] + ek)
    if dirs is None:
        dirs = torch.empty((0,), dtype=torch.uint8, device=device)
    return DPResult(score=score, end_i=ei.to(torch.int32),
                    end_j=ej.to(torch.int32), dirs=dirs)


def banded_dp_row(s_codes, t_codes, s_lens, t_lens, dmin, *, W: int, subst,
                  go: float, ge: float, flags: ModeFlags, w_eff=None,
                  A: int = None, with_dirs: bool = False,
                  device="cuda", _geometry: Geometry = None) -> DPResult:
    """Row-form banded DP over a batch of pairs.

    Inputs (numpy arrays, or tensors already on ``device``):
    ``s_codes`` [B, LS] and ``t_codes`` [B, LT] letter codes (below
    ``A``; negative codes are PAD), ``s_lens`` / ``t_lens`` / ``dmin`` /
    ``w_eff`` int32 [B].  ``W`` is a multiple of 128 (the kernel takes up
    to :data:`MAX_W`, the twin any); ``subst`` [A, A] with ``A``
    (at most 127) defaulting to its size; ``go, ge <= 0``.

    Returns :class:`DPResult` (contract: module docstring).  On a CUDA
    ``device`` this launches the kernel of ``csrc/dp_row.cu`` (built on
    first use) in the geometry :func:`plan` picks (``_geometry`` names
    another instance, for measurements and tests) and raises if it
    cannot; on the CPU it runs :func:`banded_dp_row_reference`.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        return _run(_sweep_plain, s_codes, t_codes, s_lens, t_lens, dmin, W,
                    subst, go, ge, flags, w_eff, A, with_dirs, device)
    return _run(_sweep_cuda, s_codes, t_codes, s_lens, t_lens, dmin, W,
                subst, go, ge, flags, w_eff, A, with_dirs, device,
                geometry=_geometry)


def banded_dp_row_reference(s_codes, t_codes, s_lens, t_lens, dmin, *,
                            W: int, subst, go: float, ge: float,
                            flags: ModeFlags, w_eff=None, A: int = None,
                            with_dirs: bool = False,
                            device="cuda") -> DPResult:
    """The plain PyTorch twin of :func:`banded_dp_row` on any device
    (vectorised over pairs and lanes, a Python loop over rows): same
    arguments, same outputs, bit for bit."""
    return _run(_sweep_plain, s_codes, t_codes, s_lens, t_lens, dmin, W,
                subst, go, ge, flags, w_eff, A, with_dirs,
                resolve_device(device))
