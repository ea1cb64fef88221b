"""Compaction of the walk's op trace into MSID transcripts, on the device:
CUDA kernel + plain twin.

Replaces no TPU kernel.  The JAX package copies the walk's 2-bit op
trace to the host and replays it there in C++
(``native.compact_sweep_ops_t``); this op computes the same bytes where
the trace already is, so that only the finished transcripts cross to
the host.  The C++ compactor stays, for the CPU route and as the tests'
oracle.

Semantics (``bst_compact_sweep_batch_t``'s, byte for byte): pair b's
ops sit in column ``b // 2`` of plane ``b % 2`` of the trace
(:mod:`.walk`'s layout), antidiagonal a's op in bits ``2 * (a % 4)`` of
byte row ``a // 4``.  The replay ascends from the walk's final cursor
``(fin_i, fin_j)`` over the antidiagonals ``a >= fin_i + fin_j``: op 1
writes ``M`` or ``S`` by comparing ``s[i]`` with ``t[j]`` and moves
both, op 2 writes ``I`` and moves j, op 3 writes ``D`` and moves i.
Anchored modes (neither a local nor a free start) put ``D^fin_i
I^fin_j`` first; ``fin_i < 0`` or ``fin_j < 0`` skips a pair (length
0).  Where the C++ replay trusts its inputs, this op holds every pair
to its own row: a live pair whose cursor or replay would leave
``[0, s_len] x [0, t_len]``, or whose transcript would pass its row of
``stride - 1`` bytes (the C++ guard), gets length -1 and reads nothing.
:func:`transcripts` then raises on the host as the C++ binding does.

Each op's place in its transcript is the count of ops before it and its
cell the start cell plus the moves before it: prefix sums over the
trace, so the kernel (``csrc/walk.cu``, ``compact_kernel``) replays a
pair with a block of threads (:func:`plan`) in rounds of a row a
thread, a block-wide scan a round, and the twin with cumulative sums
over all pairs at once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from ..profiling import count

__all__ = ["compact", "compact_reference", "transcripts", "plan", "ROUNDS",
           "MAX_THREADS"]

# rounds of a trace row a thread that a block replays at most, while it
# has room (MAX_THREADS: the kernel's largest block)
ROUNDS = 16
MAX_THREADS = 1024

# the transcript letters of ops 1 (M, S), 2 and 3
_LETTERS = list(b"MSID")


def plan(rows: int) -> int:
    """Threads a block of the kernel, which replays one pair's trace of
    ``rows`` byte rows in rounds of a row a thread: the smallest power of
    two from 32 that takes it in at most :data:`ROUNDS` rounds, and
    :data:`MAX_THREADS` for longer traces.  On an H100 (PERF.md) the
    batched extension's 6176-row traces took 0.22-0.23 ms for 2048 pairs
    at 96, 256 and 512 threads (0.28-0.32 at 32, 128, 800 and 1024), and
    four genome-window traces of ~100 k rows fell from 2.6 ms at 32
    threads to 0.15 ms at 1024."""
    threads = 32
    while threads < MAX_THREADS and threads * ROUNDS < rows:
        threads *= 2
    return threads


def _inputs(trace, fin_i, fin_j, s_codes, t_codes, s_lens, t_lens):
    """The op's tensors checked (one device, the kernel's dtypes and
    ranks) and made contiguous, and ``B``: as many pairs as every input
    holds."""
    named = dict(trace=trace, fin_i=fin_i, fin_j=fin_j, s_codes=s_codes,
                 t_codes=t_codes, s_lens=s_lens, t_lens=t_lens)
    for name, x in named.items():
        if not isinstance(x, torch.Tensor):
            raise ValueError("%s must be a tensor, got %s"
                             % (name, type(x).__name__))
        if x.device != trace.device:
            raise ValueError("%s on %s, the trace on %s"
                             % (name, x.device, trace.device))
    if trace.dtype != torch.uint8 or trace.dim() != 3 or trace.shape[0] != 2:
        raise ValueError("trace must be uint8 [2, rows, B2], got %s %s"
                         % (trace.dtype, tuple(trace.shape)))
    for name in ("s_codes", "t_codes"):
        x = named[name]
        if x.dtype != torch.int8 or x.dim() != 2:
            raise ValueError("%s must be int8 [B, L], got %s %s"
                             % (name, x.dtype, tuple(x.shape)))
    for name in ("fin_i", "fin_j", "s_lens", "t_lens"):
        x = named[name]
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError("%s must be int32 [B], got %s %s"
                             % (name, x.dtype, tuple(x.shape)))
    B = min(2 * trace.shape[2], s_codes.shape[0], t_codes.shape[0],
            *(named[k].shape[0] for k in ("fin_i", "fin_j", "s_lens",
                                          "t_lens")))
    return [x.contiguous() for x in named.values()] + [B]


def _compact_plain(trace, fi, fj, s, t, sl, tl, B, anchored, stride):
    dev = trace.device
    TRb = trace.shape[1]
    LS, LT = s.shape[1], t.shape[1]
    b = torch.arange(B, device=dev)
    shifts = torch.arange(0, 8, 2, device=dev, dtype=torch.int32)
    # op of antidiagonal a = 4 r + k of each pair: [B, 4 TRb]
    op = ((trace[b % 2, :, b // 2].to(torch.int32)[..., None] >> shifts)
          & 3).reshape(B, 4 * TRb)
    moves_i = ((op & 1) != 0).sum(1, dtype=torch.int32)
    moves_j = (((op ^ (op >> 1)) & 1) != 0).sum(1, dtype=torch.int32)
    I0, J0 = fi[:B].long(), fj[:B].long()
    sl = sl[:B].long().clamp(max=LS)
    tl = tl[:B].long().clamp(max=LT)
    live = (I0 >= 0) & (J0 >= 0)
    inside = live & (I0 <= sl) & (J0 <= tl)
    a0 = torch.where(inside, I0 + J0, 4 * TRb)
    op = torch.where(torch.arange(4 * TRb, device=dev) >= a0[:, None], op, 0)
    nz = op != 0
    mi = (op & 1) != 0
    mj = ((op ^ (op >> 1)) & 1) != 0
    pre = torch.where(inside & anchored, I0 + J0, 0)
    length = pre + nz.sum(1)
    bad = live & (~inside | (I0 + mi.sum(1) > sl) | (J0 + mj.sum(1) > tl)
                  | (length > stride - 1))
    ops_len = torch.where(~live, 0, torch.where(bad, -1, length)).int()
    good = live & ~bad
    # each replayed op's place and cell: the ops and moves before it
    row, a = (nz & good[:, None]).nonzero(as_tuple=True)
    o = op[row, a]
    pos = (pre[:, None] + nz.cumsum(1) - nz.long())[row, a]
    at_i = (I0[:, None] + mi.cumsum(1) - mi.long())[row, a]
    at_j = (J0[:, None] + mj.cumsum(1) - mj.long())[row, a]
    letters = torch.tensor(_LETTERS, dtype=torch.uint8, device=dev)
    ch = letters[torch.where(o == 2, 2, 3)]
    d = o == 1
    same = s[row[d], at_i[d]] == t[row[d], at_j[d]]
    ch[d] = letters[torch.where(same, 0, 1)]
    ops = torch.zeros((B, stride), dtype=torch.uint8, device=dev)
    ops[row, pos] = ch
    k = torch.arange(stride, device=dev)
    head = good[:, None] & (k < pre[:, None])
    ops = torch.where(head, letters[torch.where(k < I0[:, None], 3, 2)],
                      ops)
    return ops, ops_len, moves_i, moves_j


def _compact_cuda(trace, fi, fj, s, t, sl, tl, B, anchored, stride):
    from .. import _build
    from .walk import _declare

    lib = _build.load("walk", _declare)
    dev = trace.device
    ops = torch.empty((B, stride), dtype=torch.uint8, device=dev)
    ops_len = torch.empty((B,), dtype=torch.int32, device=dev)
    moves_i = torch.empty_like(ops_len)
    moves_j = torch.empty_like(ops_len)
    _, TRb, B2 = trace.shape
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = lib.bst_compact(
        ptr(trace), TRb, B2, ptr(s), s.shape[1], ptr(t), t.shape[1],
        ptr(sl), ptr(tl), ptr(fi), ptr(fj), int(anchored), B, stride,
        plan(TRb), ptr(ops), ptr(ops_len), ptr(moves_i), ptr(moves_j),
        dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, rc, "compact launch")
    count("launches.compact")
    return ops, ops_len, moves_i, moves_j


def _run(engine, trace, fin_i, fin_j, s_codes, t_codes, s_lens, t_lens,
         mode_flags):
    *x, B = _inputs(trace, fin_i, fin_j, s_codes, t_codes, s_lens, t_lens)
    stride = s_codes.shape[1] + t_codes.shape[1] + 2
    if B == 0:
        dev = trace.device
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return (torch.zeros((0, stride), dtype=torch.uint8, device=dev),
                empty, empty, empty)
    anchored = not (native._flags_of(mode_flags)
                    & (native.MODE_LOCAL_START | native.MODE_FREE_START_EDGES))
    return engine(*x, B, anchored, stride)


def compact(trace, fin_i, fin_j, s_codes, t_codes, s_lens, t_lens,
            mode_flags):
    """Replay B pairs' op traces into MSID transcript bytes, on the
    trace's device.

    ``trace``: uint8 [2, rows, B2] from :func:`.walk.traceback_walk`;
    ``fin_i`` / ``fin_j``: the walk's final cursors, int32 [>= B]
    (-1 skips a pair); ``s_codes`` / ``t_codes``: int8 [>= B, LS] /
    [>= B, LT], the letters the DP read; ``s_lens`` / ``t_lens``: int32
    [>= B]; ``mode_flags``: the DP's :class:`.banded_dp.ModeFlags`.
    ``B`` is as many pairs as every input holds.  Returns
    ``(ops uint8 [B, LS + LT + 2], ops_len int32 [B], moves_i int32 [B],
    moves_j int32 [B])``: row b's transcript is its first ``ops_len[b]``
    bytes (0 for a skipped pair, -1 for a pair that would leave its
    row: module docstring), and ``moves_i`` / ``moves_j`` the moves of
    every op of its trace (:func:`.walk.trace_moves`).  Nothing waits
    for the device; :func:`transcripts` decodes the host copies.

    Tensors on a card launch ``compact_kernel`` (``csrc/walk.cu``);
    tensors on the CPU run :func:`compact_reference`.  Inputs the
    kernel does not take (another dtype, rank or device) raise
    ``ValueError``.
    """
    device = trace.device if isinstance(trace, torch.Tensor) else None
    if device is None or device.type not in ("cpu", "cuda"):
        raise ValueError("trace must be a tensor on the CPU or a card")
    engine = _compact_cuda if device.type == "cuda" else _compact_plain
    return _run(engine, trace, fin_i, fin_j, s_codes, t_codes, s_lens,
                t_lens, mode_flags)


def compact_reference(trace, fin_i, fin_j, s_codes, t_codes, s_lens, t_lens,
                      mode_flags):
    """The plain PyTorch twin of :func:`compact` on any device (every pair
    at once, cumulative sums over the trace): same arguments, same
    outputs (bytes past a row's length are 0 here, unset by the
    kernel)."""
    if not isinstance(trace, torch.Tensor):
        raise ValueError("trace must be a tensor")
    return _run(_compact_plain, trace, fin_i, fin_j, s_codes, t_codes,
                s_lens, t_lens, mode_flags)


def transcripts(ops, ops_len, fin_i, fin_j, moves, s_lens, t_lens,
                mode_flags):
    """``(ops list[str], start_i, start_j)`` from host copies (numpy) of
    :func:`compact`'s outputs for B pairs, as
    :func:`.native.compact_sweep_ops_t` returns them: each row's bytes
    decoded once; the start cells the cursors, (0, 0) in anchored modes,
    -1 for skipped pairs.  Raises as the C++ binding does: ``ValueError``
    for cursors or moves that leave a pair's matrix, ``RuntimeError``
    for a row that would overrun its buffer."""
    B = ops.shape[0]
    native._check_moves(fin_i, fin_j, moves, s_lens, t_lens, B)
    return native._replayed("compact_kernel", 0, ops,
                            np.asarray(ops_len)[:B],
                            np.asarray(fin_i, np.int32)[:B],
                            np.asarray(fin_j, np.int32)[:B], mode_flags)
