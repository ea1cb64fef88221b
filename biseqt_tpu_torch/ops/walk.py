"""Traceback walk over the packed antidiagonal dirs plane: CUDA kernel +
plain twin.

The port of :mod:`biseqt_tpu.ops.pallas_walk`.  The JAX package has two
TPU kernels for one walk — ``_kernel_t`` (``traceback_sweep_t``, walkers
along lanes) and ``_kernel`` (``traceback_sweep``, walkers along
sublanes) — that differ only in TPU layout.  The port has one walk,
which writes ``traceback_sweep_t``'s trace layout; every launch goes
through it and then through ``native.compact_sweep_ops_t``.

Semantics (held byte for byte): a walker starts at its pair's end cell
(``A = i + j``, or -2 when ``end_i < 0``: a skipped pair) and descends
antidiagonals.  At antidiagonal ``a`` it acts iff its ``A == a``: it
reads the nibble of its cell — byte row ``a // 2``, column ``b // 2``,
lane ``X = i - j - dmin'``, low nibble for even ``a``; 0 when ``X`` is
off the plane or has the other pair's parity — and applies one fused
step (``step_walk`` below: a gap entry emits its first gap op at once,
so every action emits one op and lowers ``A``).  The op of step ``a``
(0 none, 1 diag, 2 ins, 3 del) is stored in bits ``2 * (a % 4)`` of
byte row ``a // 4`` of ``trace[b % 2, :, b // 2]``; bytes of steps
where the walker does not act are 0.  The final cursors (the
alignment start) come back as ``fin_i`` / ``fin_j``.

:func:`trace_moves` counts each pair's moves in a trace, so a caller can
hold the trace to its end and start cells before replaying it.
"""

from __future__ import annotations

import ctypes

import torch

from ..profiling import count
from .banded_dp import on_device, resolve_device
from .steps import add_at, run_steps, take

__all__ = ["traceback_walk", "traceback_walk_reference", "trace_moves",
           "step_walk", "DEPTH", "OP_NONE", "OP_DIAG", "OP_INS", "OP_DEL"]

OP_NONE, OP_DIAG, OP_INS, OP_DEL = 0, 1, 2, 3

# antidiagonals of the plane window the kernel copies to shared memory
# at a time: the constant D of csrc/walk.cu
DEPTH = 64

# moves of each trace byte's four ops: [byte, (di, dj)], and its copy on
# each device (made once: a copy from host memory waits for the stream)
_MOVES = [[sum(((v >> s) & 3) in (OP_DIAG, OP_DEL) for s in (0, 2, 4, 6)),
           sum(((v >> s) & 3) in (OP_DIAG, OP_INS) for s in (0, 2, 4, 6))]
          for v in range(256)]
_MOVES_ON = {}


def step_walk(byte, act, A, X, I, J, ST):
    """One fused walker action on int tensors (``act`` bool).

    ``ST`` is the gap state encoded as the op it emits (0 in H, 2 in E
    emitting insertions, 3 in F emitting deletions).  In H, ``i == 0``
    or ``j == 0`` or a stop nibble ends the walk without an op; a gap
    source (2/3) enters the gap and emits its first op in the same
    action.  A walker in a gap is active at every antidiagonal until the
    run ends, so inactive walkers always have ``ST == 0``."""
    src = byte & 3
    stn = ST != 0
    eff = torch.where(stn, ST, src)
    stop = (torch.minimum(I, J) == 0) | (src == 0)
    keep = stn | ~stop
    emit = act & keep
    OP = torch.where(emit, eff, 0)
    di = OP & 1
    dj = (((OP + 1) & 2) != 0).to(OP.dtype)
    I2 = I - di
    J2 = J - dj
    X2 = X + (dj - di)
    A2 = torch.where(act & ~keep, -2, A - di - dj)
    is_e = OP == OP_INS
    gbit = torch.where(is_e, byte & 4, byte & 8)
    live = torch.where(is_e, J2, I2)
    cont = ((OP & 2) != 0) & (gbit != 0) & (live > 0)
    ST2 = torch.where(cont, OP, 0)
    return OP, A2, X2, I2, J2, ST2


def _inputs(dirs, dminq, end_i, end_j, W, device):
    if not isinstance(dirs, torch.Tensor) or dirs.device != device:
        raise ValueError("dirs must be a tensor on %s" % device)
    if dirs.dtype != torch.uint8 or dirs.dim() != 3 or dirs.shape[2] != W:
        raise ValueError("dirs must be uint8 [Rp, B2, %d], got %s %s"
                         % (W, dirs.dtype, tuple(dirs.shape)))

    i32 = lambda x: on_device(x, torch.int32, device).reshape(-1)
    dminq, end_i, end_j = i32(dminq), i32(end_i), i32(end_j)
    Rp, B2, _ = dirs.shape
    B = dminq.shape[0]
    if B > 2 * B2 or end_i.shape[0] != B or end_j.shape[0] != B:
        raise ValueError("%d pairs do not fit a plane of %d columns"
                         % (B, B2))
    pad = 2 * B2 - B

    def padb(x, fill):
        return torch.cat([x, x.new_full((pad,), fill)]) if pad else x

    return (dirs.contiguous(), padb(dminq, 0).contiguous(),
            padb(end_i, -1).contiguous(), padb(end_j, -1).contiguous(),
            Rp, B2, B)


def _walk_plain(dirs, dq, ei, ej, Rp, B2, W):
    dev = dirs.device
    Bp = 2 * B2
    b = torch.arange(Bp, device=dev)
    par = (b % 2).to(torch.int32)
    col = b // 2
    A = torch.where(ei < 0, -2, ei + ej).to(torch.int32)
    X = (ei - ej - dq).to(torch.int32)
    I, J = ei.clone(), ej.clone()
    ST = torch.zeros_like(I)
    TRb = (Rp + 1) // 2
    acc = torch.zeros((TRb, Bp), dtype=torch.int32, device=dev)

    def step(a, at, state):
        """Antidiagonal ``a`` (its parities from the int ``a``, the rest
        from ``at``)."""
        A, X, I, J, ST = state
        act = A == at
        on = act & (X >= 0) & (X < W) & (((at + X) % 2) == par)
        row = take(dirs, at // 2)[col, X.clamp(0, W - 1).to(torch.int64)]
        nib = (row.to(torch.int32) >> (4 * (a % 2))) & 15
        byte = torch.where(on, nib, 0)
        OP, A, X, I, J, ST = step_walk(byte, act, A, X, I, J, ST)
        add_at(acc, at // 4, OP << (2 * (a % 4)))
        return A, X, I, J, ST

    _, _, I, J, _ = run_steps(step, (A, X, I, J, ST),
                              range(2 * Rp - 1, -1, -1))
    trace = acc.to(torch.uint8).reshape(TRb, B2, 2).permute(2, 0, 1)
    return trace.contiguous(), I, J


def _walk_cuda(dirs, dq, ei, ej, Rp, B2, W):
    from .. import _build

    if W % 16 or dirs.data_ptr() % 16:
        raise ValueError("the walk kernel copies the plane in 16-byte"
                         " chunks: W must be a multiple of 16 and the plane"
                         " aligned, got W %d at offset %d"
                         % (W, dirs.data_ptr() % 16))
    lib = _build.load("walk", _declare)
    dev = dirs.device
    TRb = (Rp + 1) // 2
    trace = torch.zeros((2, TRb, B2), dtype=torch.uint8, device=dev)
    fi = torch.empty((2 * B2,), dtype=torch.int32, device=dev)
    fj = torch.empty_like(fi)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = lib.bst_walk(
        ptr(dirs), ptr(dq), ptr(ei), ptr(ej), Rp, B2, W, TRb, ptr(trace),
        ptr(fi), ptr(fj), dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, rc, "walk launch")
    count("launches.walk")
    return trace, fi, fj


def _declare(lib):
    """The entry points of ``csrc/walk.cu``: the walk and the compaction
    of its trace (:mod:`.compact`), one library."""
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.bst_walk.restype = i
    lib.bst_walk.argtypes = [v, v, v, v, i, i, i, i, v, v, v, i, v]
    lib.bst_compact.restype = i
    lib.bst_compact.argtypes = [v, i, i, v, i, v, i, v, v, v, v, i, i, i, i,
                                v, v, v, v, i, v]


def _run(engine, dirs, dminq, end_i, end_j, W, device):
    dirs, dq, ei, ej, Rp, B2, B = _inputs(dirs, dminq, end_i, end_j, W,
                                          device)
    if B2 == 0 or Rp == 0:
        # no antidiagonals to walk: empty trace, cursors untouched
        return (torch.zeros((2, 0, B2), dtype=torch.uint8, device=device),
                ei[:B], ej[:B])
    trace, fi, fj = engine(dirs, dq, ei, ej, Rp, B2, W)
    return trace, fi[:B], fj[:B]


def traceback_walk(dirs, dminq, end_i, end_j, *, W: int, device="cuda"):
    """Walk every pair's traceback over the dirs plane.

    ``dirs``: [Rp, B2, W] uint8 tensor on ``device`` (the plane of
    :func:`.dp_ad.banded_dp_ad`); ``dminq``: parity-adjusted band starts
    [B]; ``end_i`` / ``end_j``: end cells [B] (-1 skips a pair).
    Returns ``(trace [2, ceil(Rp / 2), B2] uint8, fin_i [B] int32,
    fin_j [B] int32)`` in the layout of the module docstring, ready for
    :func:`biseqt_tpu_torch.native.compact_sweep_ops_t`.

    On a CUDA ``device`` this launches the kernel of ``csrc/walk.cu``
    (``W`` a multiple of 16) and raises if it cannot; on the CPU it runs
    :func:`traceback_walk_reference`.
    """
    device = resolve_device(device)
    engine = _walk_cuda if device.type == "cuda" else _walk_plain
    return _run(engine, dirs, dminq, end_i, end_j, W, device)


def traceback_walk_reference(dirs, dminq, end_i, end_j, *, W: int,
                             device="cuda"):
    """The plain PyTorch twin of :func:`traceback_walk` on any device
    (all walkers in lockstep, a Python loop over antidiagonals): same
    arguments, same outputs, byte for byte."""
    return _run(_walk_plain, dirs, dminq, end_i, end_j, W,
                resolve_device(device))


def trace_moves(trace: torch.Tensor, B: int):
    """Each pair's moves in a walk's trace, on the trace's device:
    ``(di, dj)``, int32 [B], where ``di`` counts its diagonal and
    deletion ops (rows of S consumed) and ``dj`` its diagonal and
    insertion ops (letters of T consumed).  ``trace`` is
    [2, rows, B2] uint8 in the layout of the module docstring (pair b
    owns column ``b // 2`` of plane ``b % 2``).  A walk from end cell
    ``(i, j)`` to start cell ``(fi, fj)`` has ``di == i - fi`` and
    ``dj == j - fj``.

    Four device operations: the trace's int32 copy (indices), one gather
    from a 256-entry table of each byte's moves (uint8), one int32 sum
    over the rows and the reorder of the [2, B2] columns into pairs."""
    lut = _MOVES_ON.get(trace.device)
    if lut is None:
        lut = _MOVES_ON[trace.device] = torch.tensor(
            _MOVES, dtype=torch.uint8, device=trace.device)
    moves = lut[trace.int()].sum(dim=1, dtype=torch.int32)  # [2, B2, 2]
    moves = moves.transpose(0, 1).reshape(-1, 2)[:B]
    return moves[:, 0], moves[:, 1]
