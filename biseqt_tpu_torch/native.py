"""ctypes binding to the port's C++ host tier (``pwnative.cpp``).

The port keeps its own copy of the JAX package's C++ host tier,
``csrc/pwnative.cpp`` (byte for byte the same source; a test guards
against drift), and compiles it with the flags of the JAX package's
``native/Makefile`` into this package's git-ignored ``build/``
directory the first time it is needed.  Bound: :func:`align` and
:func:`traceback` (the host DP engine behind ``pw.Aligner(backend=
"native")``), :func:`traceback_batch` (the host walker over the row
engine's dirs planes, the row route of ``pipeline.extend_segments``),
:func:`traceback_batch_ad` (the host walker over an antidiagonal dirs
plane), :func:`traceback_ad_window_batch` (the resumable walker over one
window of the band-sharded traceback), :func:`compact_sweep_ops_t` and
:func:`compact_sweep_ops` (op traces -> MSID transcripts, in the walk
kernel's layout and in the JAX package's sublane walk's) and
:func:`fasta_pack` (the FASTA packer behind ``database.DB.load_fasta``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

__all__ = [
    "available", "align", "traceback", "traceback_batch",
    "traceback_batch_ad", "traceback_ad_window_batch", "compact_sweep_ops",
    "compact_sweep_ops_t", "dna_code_map", "fasta_pack",
    "MODE_FREE_START_EDGES", "MODE_LOCAL_START",
    "MODE_FREE_END_EDGES", "MODE_LOCAL_END",
]

MODE_FREE_START_EDGES = 1
MODE_LOCAL_START = 2
MODE_FREE_END_EDGES = 4
MODE_LOCAL_END = 8

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "pwnative.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
_SO = os.path.join(BUILD_DIR, "libpwnative.so")
# the flags of the JAX package's native/Makefile
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-Wall",
             "-std=c++17"]

# Must match bst_abi_version() in pwnative.cpp: the argtypes below
# describe this version's signatures, and calling a library built from
# another version through them shifts pointer arguments.
_ABI_VERSION = 2

_lib = None


def _build():
    """Compile the source into ``build/libpwnative.so``.  The
    library is written under a temporary name and renamed into place,
    so concurrent test workers never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, SOURCE],
            check=True, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO)
            or os.path.getmtime(SOURCE) > os.path.getmtime(_SO)):
        _build()
    lib = ctypes.CDLL(_SO)
    so_abi = int(lib.bst_abi_version())
    if so_abi != _ABI_VERSION:
        raise RuntimeError(
            "%s has ABI version %d, the binding expects %d — delete it to "
            "rebuild" % (_SO, so_abi, _ABI_VERSION))
    lib.bst_align.restype = ctypes.c_int
    lib.bst_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_traceback.restype = ctypes.c_int
    lib.bst_traceback.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_traceback_batch.restype = ctypes.c_int
    lib.bst_traceback_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_traceback_ad_batch.restype = ctypes.c_int
    lib.bst_traceback_ad_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_traceback_ad_window_batch.restype = ctypes.c_int
    lib.bst_traceback_ad_window_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_compact_sweep_batch.restype = ctypes.c_int
    lib.bst_compact_sweep_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_compact_sweep_batch_t.restype = ctypes.c_int
    lib.bst_compact_sweep_batch_t.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_fasta_scan.restype = ctypes.c_int
    lib.bst_fasta_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_fasta_pack.restype = ctypes.c_int64
    lib.bst_fasta_pack.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the C++ tier loads (building it first if needed)."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, RuntimeError):
        return False


def _flags_of(mode_flags) -> int:
    f = 0
    if getattr(mode_flags, "free_start_edges", False):
        f |= MODE_FREE_START_EDGES
    if getattr(mode_flags, "local_start", False):
        f |= MODE_LOCAL_START
    if getattr(mode_flags, "free_end_edges", False):
        f |= MODE_FREE_END_EDGES
    if getattr(mode_flags, "local_end", False):
        f |= MODE_LOCAL_END
    return f


def align(s, t, subst, go, ge, dmin, dmax, mode_flags, with_dirs=False):
    """Host banded affine DP of one pair over diagonals ``[dmin, dmax]``
    (``dmin = -len(t)``, ``dmax = len(s)`` for the full matrix); same
    conventions as :func:`biseqt_tpu_torch.ops.banded_dp.banded_dp`.
    Returns ``(score, end_i, end_j, dirs [len(s), W] uint8 or None)``
    with ``W = dmax - dmin + 1`` and lane ``k`` the diagonal
    ``dmax - k``."""
    lib = _load()
    s = np.ascontiguousarray(s, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    subst = np.ascontiguousarray(subst, np.float32)
    A = subst.shape[0]
    W = int(dmax) - int(dmin) + 1
    dirs = np.zeros((len(s), W), np.uint8) if with_dirs else None
    score = ctypes.c_float()
    ei = ctypes.c_int()
    ej = ctypes.c_int()
    rc = lib.bst_align(
        s.ctypes.data, len(s), t.ctypes.data, len(t),
        subst.ctypes.data, A, float(go), float(ge),
        int(dmin), int(dmax), _flags_of(mode_flags),
        ctypes.byref(score), ctypes.byref(ei), ctypes.byref(ej),
        dirs.ctypes.data if dirs is not None else None,
    )
    if rc != 0:
        raise RuntimeError("bst_align failed (%d)" % rc)
    return float(score.value), int(ei.value), int(ej.value), dirs


def traceback(dirs, dmax, s, t, end_i, end_j, mode_flags):
    """Host walk over the ``[len(s), W]`` direction bytes of
    :func:`align`; returns ``(ops_str, start_i, start_j)``."""
    lib = _load()
    dirs = np.ascontiguousarray(dirs, np.uint8)
    W = dirs.shape[1]
    s = np.ascontiguousarray(s, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    buf = ctypes.create_string_buffer(len(s) + len(t) + 2)
    si = ctypes.c_int()
    sj = ctypes.c_int()
    n = lib.bst_traceback(
        dirs.ctypes.data, W, int(dmax),
        s.ctypes.data, len(s), t.ctypes.data, len(t),
        int(end_i), int(end_j), _flags_of(mode_flags),
        buf, ctypes.byref(si), ctypes.byref(sj),
    )
    if n < 0:
        raise RuntimeError("bst_traceback left the band (%d)" % n)
    return buf.value.decode("ascii"), int(si.value), int(sj.value)


def _decode(ops_buf, ops_len):
    """Row b's first ``ops_len[b]`` bytes of ``ops_buf`` [B, stride] as an
    ASCII str, each read in place from one flat view of the buffer."""
    flat = memoryview(np.ascontiguousarray(ops_buf)).cast("B")
    stride = ops_buf.shape[1]
    return [str(flat[b * stride: b * stride + n], "ascii")
            for b, n in enumerate(np.asarray(ops_len).tolist())]


def traceback_batch(dirs, dmax, s_codes, t_codes, s_lens, t_lens, end_i,
                    end_j, mode_flags):
    """Batched host traceback over the row engine's direction bytes.

    ``dirs``: [B, rows, W] uint8 (numpy), the lax-format planes of
    :func:`biseqt_tpu_torch.ops.banded_dp.banded_dp` (row r = DP row
    r + 1, lane k the diagonal ``dmax - k``); ``dmax``: each pair's top
    diagonal [B], ``dmin + W - 1``; ``end_i`` / ``end_j``: the engine's
    end cells [B].  Every per-pair array holds exactly the plane's B
    pairs, and each end cell lies inside its pair's matrix, which lies
    inside the plane and the codes, or ``ValueError`` is raised.  A walk
    that leaves the band (a wrong ``dmax`` or end cell, a corrupted
    plane) raises ``RuntimeError``.  Returns ``(ops list[str], start_i
    int32[B], start_j int32[B])``.
    """
    lib = _load()
    dirs = np.ascontiguousarray(dirs, np.uint8)
    if dirs.ndim != 3:
        raise ValueError("dirs must be [B, rows, W], got %s" % (dirs.shape,))
    B, rows, W = dirs.shape
    s_codes = np.ascontiguousarray(s_codes, np.int8)
    t_codes = np.ascontiguousarray(t_codes, np.int8)
    i32 = lambda x: np.ascontiguousarray(x, np.int32)
    dmax, s_lens, t_lens, end_i, end_j = map(
        i32, (dmax, s_lens, t_lens, end_i, end_j))
    if (s_codes.ndim != 2 or t_codes.ndim != 2
            or s_codes.shape[0] != B or t_codes.shape[0] != B
            or any(x.shape != (B,)
                   for x in (dmax, s_lens, t_lens, end_i, end_j))):
        raise ValueError(
            "the plane holds %d pairs; codes %s / %s, dmax, lengths and end"
            " cells %s must hold as many" % (
                B, s_codes.shape, t_codes.shape,
                [x.shape for x in (dmax, s_lens, t_lens, end_i, end_j)]))
    bad = np.nonzero((end_i < 0) | (end_j < 0) | (end_i > s_lens)
                     | (end_j > t_lens)
                     | (s_lens > min(rows, s_codes.shape[1]))
                     | (t_lens > t_codes.shape[1]))[0]
    if bad.size:
        raise ValueError(
            "end cells outside their pair's matrix, or a matrix larger than"
            " the plane or the codes, for pairs %s (end %s, %s; lengths %s,"
            " %s; plane rows %d)" % (
                bad[:8].tolist(), end_i[bad[:8]].tolist(),
                end_j[bad[:8]].tolist(), s_lens[bad[:8]].tolist(),
                t_lens[bad[:8]].tolist(), rows))
    ops_stride = int(s_codes.shape[1] + t_codes.shape[1] + 2)
    ops_buf = np.zeros((B, ops_stride), np.uint8)
    start_i = np.zeros((B,), np.int32)
    start_j = np.zeros((B,), np.int32)
    ops_len = np.zeros((B,), np.int32)
    rc = lib.bst_traceback_batch(
        dirs.ctypes.data, rows, W, dmax.ctypes.data,
        s_codes.ctypes.data, s_codes.shape[1],
        t_codes.ctypes.data, t_codes.shape[1],
        s_lens.ctypes.data, t_lens.ctypes.data,
        end_i.ctypes.data, end_j.ctypes.data,
        _flags_of(mode_flags), B, ops_stride,
        ops_buf.ctypes.data, start_i.ctypes.data, start_j.ctypes.data,
        ops_len.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError("bst_traceback_batch failed (%d)" % rc)
    bad = np.nonzero(ops_len < 0)[0]
    if bad.size:
        raise RuntimeError(
            "traceback walk left the direction plane for pairs %s — wrong "
            "dmax, wrong end cell, or corrupted dirs" % bad[:8].tolist())
    return _decode(ops_buf, ops_len), start_i, start_j


def traceback_batch_ad(dirs, dminq, s_codes, t_codes, s_lens, t_lens,
                       end_i, end_j, mode_flags):
    """Batched host traceback over the packed antidiagonal dirs plane.

    ``dirs``: [Apad // 2, B2, W] uint8 (numpy), the row-major plane of
    :func:`biseqt_tpu_torch.ops.dp_ad.banded_dp_ad` — pairs
    (2*b2, 2*b2+1) share column b2, steps (2r, 2r+1) share byte row r
    (low/high nibble).  ``dminq``: the parity-adjusted band starts
    [B].  Returns ``(ops list[str], start_i int32[B], start_j int32[B])``.
    """
    lib = _load()
    dirs = np.ascontiguousarray(dirs, np.uint8)
    rows, b2_cols, W = dirs.shape
    s_codes = np.ascontiguousarray(s_codes, np.int8)
    t_codes = np.ascontiguousarray(t_codes, np.int8)
    i32 = lambda x: np.ascontiguousarray(x, np.int32)
    dminq, s_lens, t_lens, end_i, end_j = map(
        i32, (dminq, s_lens, t_lens, end_i, end_j))
    B = int(s_codes.shape[0])
    if 2 * b2_cols < B:
        raise ValueError("dirs plane has %d pair columns but %d pairs"
                         % (b2_cols, B))
    ops_stride = int(s_codes.shape[1] + t_codes.shape[1] + 2)
    ops_buf = np.zeros((B, ops_stride), np.uint8)
    start_i = np.zeros((B,), np.int32)
    start_j = np.zeros((B,), np.int32)
    ops_len = np.zeros((B,), np.int32)
    rc = lib.bst_traceback_ad_batch(
        dirs.ctypes.data, rows, b2_cols, W, dminq.ctypes.data,
        s_codes.ctypes.data, s_codes.shape[1],
        t_codes.ctypes.data, t_codes.shape[1],
        s_lens.ctypes.data, t_lens.ctypes.data,
        end_i.ctypes.data, end_j.ctypes.data,
        _flags_of(mode_flags), B, ops_stride,
        ops_buf.ctypes.data, start_i.ctypes.data, start_j.ctypes.data,
        ops_len.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError("bst_traceback_ad_batch failed (%d)" % rc)
    bad = np.nonzero(ops_len < 0)[0]
    if bad.size:
        raise RuntimeError(
            "AD traceback walk left the byte plane for pairs %s — wrong "
            "dminq, wrong end cell, or corrupted dirs" % bad[:8].tolist())
    return _decode(ops_buf, ops_len), start_i, start_j


def traceback_ad_window_batch(dirs_win, a_base, dminq, s_codes, t_codes,
                              io_i, io_j, io_state, io_done,
                              ops_stride: int):
    """One window of the band-sharded checkpointed traceback
    (:func:`biseqt_tpu_torch.parallel.sharded_dp_ad.band_sharded_ad_traceback`).

    ``dirs_win``: [B2, n_steps, W] UNPACKED direction bytes (numpy) of
    antidiagonals ``a_base .. a_base + n_steps - 1`` (the window
    re-solve's output; pairs (2*b2, 2*b2+1) share plane b2 on
    complementary parities).  ``io_i`` / ``io_j`` / ``io_state`` /
    ``io_done`` are int32 [B] walk cursors advanced IN PLACE; a live
    pair's cursor must lie inside its matrix (the walker reads the
    letters there without bounds).  Returns the list of per-pair
    BACKWARD op segments emitted inside this window (empty for inactive
    pairs); the caller concatenates segments across windows (newest
    first) and reverses once.
    """
    lib = _load()
    dirs_win = np.ascontiguousarray(dirs_win, np.uint8)
    if dirs_win.ndim != 3:
        raise ValueError("dirs_win must be [B2, n_steps, W], got %s"
                         % (dirs_win.shape,))
    b2_cols, n_steps, W = dirs_win.shape
    s_codes = np.ascontiguousarray(s_codes, np.int8)
    t_codes = np.ascontiguousarray(t_codes, np.int8)
    dminq = np.ascontiguousarray(dminq, np.int32)
    B = int(s_codes.shape[0])
    if t_codes.shape[0] != B or dminq.shape[0] < B or 2 * b2_cols < B:
        raise ValueError(
            "window %s, dminq [%d] and codes %s / %s do not hold the same %d"
            " pairs" % (dirs_win.shape, dminq.shape[0], s_codes.shape,
                        t_codes.shape, B))
    for name, cur in (("io_i", io_i), ("io_j", io_j),
                      ("io_state", io_state), ("io_done", io_done)):
        if not (isinstance(cur, np.ndarray) and cur.dtype == np.int32
                and cur.flags["C_CONTIGUOUS"] and cur.flags["WRITEABLE"]
                and cur.shape == (B,)):
            raise ValueError("walk cursor %s must be a writeable contiguous"
                             " int32 [%d] array (it is advanced in place)"
                             % (name, B))
    live = io_done == 0
    bad = np.nonzero(live & ((io_i < 0) | (io_j < 0)
                             | (io_i > s_codes.shape[1])
                             | (io_j > t_codes.shape[1])
                             | (io_state < 0) | (io_state > 2)))[0]
    if bad.size:
        raise ValueError("walk cursors outside their pair's matrix for pairs"
                         " %s (i %s, j %s, state %s)"
                         % (bad[:8].tolist(), io_i[bad[:8]].tolist(),
                            io_j[bad[:8]].tolist(),
                            io_state[bad[:8]].tolist()))
    if ops_stride < s_codes.shape[1] + t_codes.shape[1] + 2:
        raise ValueError("ops_stride %d is below LS + LT + 2" % ops_stride)
    ops_buf = np.zeros((B, int(ops_stride)), np.uint8)
    ops_len = np.zeros((B,), np.int32)
    rc = lib.bst_traceback_ad_window_batch(
        dirs_win.ctypes.data, n_steps, W, int(a_base), dminq.ctypes.data,
        s_codes.ctypes.data, s_codes.shape[1],
        t_codes.ctypes.data, t_codes.shape[1],
        B, int(ops_stride),
        io_i.ctypes.data, io_j.ctypes.data, io_state.ctypes.data,
        io_done.ctypes.data, ops_buf.ctypes.data, ops_len.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError("bst_traceback_ad_window_batch failed (%d)" % rc)
    bad = np.nonzero(ops_len < 0)[0]
    if bad.size:
        raise RuntimeError(
            "AD window walk left the byte plane for pairs %s — wrong dminq,"
            " wrong end cell, or corrupted dirs" % bad[:8].tolist())
    return _decode(ops_buf, ops_len)


def _replay_inputs(trace, fin_i, fin_j, s_codes, t_codes, s_lens, t_lens,
                   moves):
    """The compactors' inputs, made contiguous and checked: ``trace`` in
    the lane-packed layout [2, Atr, B2cols] (pair b owns column b // 2
    of plane b % 2).  The C++ replay moves its cursors once per op from
    ``(fin_i, fin_j)`` and reads the letters there without bounds, so
    every live pair must stay inside its matrix: ``0 <= fin``,
    ``fin_i + di <= s_len`` and ``fin_j + dj <= t_len``, where ``moves
    = (di, dj)`` [B] are the trace's moves, counted from ``trace`` when
    not given; ``ValueError`` otherwise.  Returns ``(s_codes, t_codes,
    fin_i, fin_j)``."""
    s_codes = np.ascontiguousarray(s_codes, np.int8)
    t_codes = np.ascontiguousarray(t_codes, np.int8)
    fin_i = np.ascontiguousarray(fin_i, np.int32)
    fin_j = np.ascontiguousarray(fin_j, np.int32)
    B = int(s_codes.shape[0])
    if 2 * trace.shape[2] < B or fin_i.shape[0] < B or fin_j.shape[0] < B:
        raise ValueError("trace %s / cursors too small for %d pairs"
                         % (trace.shape, B))
    if moves is None:
        import torch
        from .ops.walk import trace_moves

        moves = [m.numpy() for m in trace_moves(torch.from_numpy(trace), B)]
    _check_moves(fin_i, fin_j, moves, s_lens, t_lens, B)
    return s_codes, t_codes, fin_i, fin_j


def _check_moves(fin_i, fin_j, moves, s_lens, t_lens, B):
    """Raise ``ValueError`` unless every live pair of the first ``B``
    (``fin >= 0``) replays inside its matrix: ``fin_i <= s_len``,
    ``fin_j <= t_len``, ``fin_i + di <= s_len`` and ``fin_j + dj <=
    t_len``, where ``moves = (di, dj)`` are its trace's moves."""
    s_lens = np.asarray(s_lens, np.int64)[:B]
    t_lens = np.asarray(t_lens, np.int64)[:B]
    fi = np.asarray(fin_i, np.int64)[:B]
    fj = np.asarray(fin_j, np.int64)[:B]
    di, dj = (np.asarray(m, np.int64)[:B] for m in moves)
    if di.shape[0] < B or dj.shape[0] < B:
        raise ValueError("moves hold %d / %d pairs, not %d"
                         % (di.shape[0], dj.shape[0], B))
    live = (fi >= 0) & (fj >= 0)
    bad = np.nonzero(live & ((fi > s_lens) | (fj > t_lens)))[0]
    if bad.size:
        raise ValueError(
            "walk cursors outside their pair's matrix for pairs %s "
            "(fin_i %s, fin_j %s)" % (bad[:8].tolist(),
                                      fi[bad[:8]].tolist(),
                                      fj[bad[:8]].tolist()))
    bad = np.nonzero(live & ((fi + di > s_lens) | (fj + dj > t_lens)))[0]
    if bad.size:
        raise ValueError(
            "trace replay would leave its pair's matrix for pairs %s "
            "(from (%s, %s) by (%s, %s) moves)"
            % (bad[:8].tolist(), fi[bad[:8]].tolist(), fj[bad[:8]].tolist(),
               di[bad[:8]].tolist(), dj[bad[:8]].tolist()))


def _replayed(name, rc, ops_buf, ops_len, fin_i, fin_j, mode_flags):
    """A compactor's ``(ops, start_i, start_j)``: anchored modes prepend
    D^i I^j tails, so the reported start is (0, 0); skipped pairs keep
    -1.  A failed call or an overrun replay raises ``RuntimeError``."""
    if rc != 0:
        raise RuntimeError("%s failed (%d)" % (name, rc))
    bad = np.nonzero(ops_len < 0)[0]
    if bad.size:
        raise RuntimeError(
            "sweep trace replay overran for pairs %s — corrupted trace or "
            "mismatched final cursors" % bad[:8].tolist())
    B = ops_buf.shape[0]
    f = _flags_of(mode_flags)
    anchored = not (f & (MODE_LOCAL_START | MODE_FREE_START_EDGES))
    si = fin_i[:B].copy()
    sj = fin_j[:B].copy()
    if anchored:
        started = si >= 0
        si[started] = 0
        sj[started] = 0
    return _decode(ops_buf, ops_len), si, sj


def compact_sweep_ops_t(trace, fin_i, fin_j, s_codes, t_codes, s_lens,
                        t_lens, mode_flags, *, moves=None):
    """Turn the walk's op traces into MSID transcripts.

    ``trace``: [2, Atr, B2cols] uint8 (numpy) from
    :func:`biseqt_tpu_torch.ops.walk.traceback_walk` — pair b owns
    column b // 2 of plane b % 2; ``fin_i`` / ``fin_j``: the walk's
    final cursors [B] (-1 = skipped pair).  The C++ replay moves its
    cursors once per op from ``(fin_i, fin_j)`` and reads the letters
    there without bounds, so a faulty walk would otherwise read a
    neighbouring pair's row: every live pair must stay inside its
    matrix, ``fin_i + di <= s_len`` and ``fin_j + dj <= t_len`` (and
    ``fin >= 0``), where ``moves = (di, dj)`` [B] are the trace's moves
    (:func:`biseqt_tpu_torch.ops.walk.trace_moves`), counted here from
    ``trace`` when not given.  Raises ``ValueError`` otherwise.  Returns
    ``(ops list[str], start_i, start_j)``.
    """
    lib = _load()
    trace = np.ascontiguousarray(trace, np.uint8)
    if trace.ndim != 3 or trace.shape[0] != 2:
        raise ValueError("trace must be [2, Atr, B2cols], got %s"
                         % (trace.shape,))
    _, atr, b2_cols = trace.shape
    s_codes, t_codes, fin_i, fin_j = _replay_inputs(
        trace, fin_i, fin_j, s_codes, t_codes, s_lens, t_lens, moves)
    B = int(s_codes.shape[0])
    ops_stride = int(s_codes.shape[1] + t_codes.shape[1] + 2)
    ops_buf = np.zeros((B, ops_stride), np.uint8)
    ops_len = np.zeros((B,), np.int32)
    rc = lib.bst_compact_sweep_batch_t(
        trace.ctypes.data, atr, b2_cols,
        s_codes.ctypes.data, s_codes.shape[1],
        t_codes.ctypes.data, t_codes.shape[1],
        fin_i.ctypes.data, fin_j.ctypes.data,
        _flags_of(mode_flags), B, ops_stride,
        ops_buf.ctypes.data, ops_len.ctypes.data,
    )
    return _replayed("bst_compact_sweep_batch_t", rc, ops_buf, ops_len,
                     fin_i, fin_j, mode_flags)


def compact_sweep_ops(trace0, trace1, fin_i, fin_j, s_codes, t_codes,
                      s_lens, t_lens, mode_flags, *, moves=None):
    """Turn the JAX package's sublane walk's op traces into MSID
    transcripts (the counterpart of its ``native.compact_sweep_ops``).

    ``trace0`` / ``trace1``: [B2, Atr] uint8 (numpy), the two traces of
    ``biseqt_tpu.ops.pallas_walk.traceback_sweep`` — pair b owns row
    b // 2 of trace ``b % 2``; ``fin_i`` / ``fin_j``: the walk's final
    cursors [B] (-1 = skipped pair).  The port's walk writes the
    lane-packed layout (:func:`compact_sweep_ops_t`); no path of the
    port makes this one.  Cursors and moves are checked as
    :func:`compact_sweep_ops_t` checks them (``ValueError``).  Returns
    ``(ops list[str], start_i, start_j)``.
    """
    lib = _load()
    trace0 = np.ascontiguousarray(trace0, np.uint8)
    trace1 = np.ascontiguousarray(trace1, np.uint8)
    if trace0.ndim != 2 or trace0.shape != trace1.shape:
        raise ValueError("trace0 / trace1 must both be [B2, Atr], got %s /"
                         " %s" % (trace0.shape, trace1.shape))
    atr = int(trace0.shape[1])
    s_codes, t_codes, fin_i, fin_j = _replay_inputs(
        np.stack([trace0.T, trace1.T]), fin_i, fin_j, s_codes, t_codes,
        s_lens, t_lens, moves)
    B = int(s_codes.shape[0])
    ops_stride = int(s_codes.shape[1] + t_codes.shape[1] + 2)
    ops_buf = np.zeros((B, ops_stride), np.uint8)
    ops_len = np.zeros((B,), np.int32)
    rc = lib.bst_compact_sweep_batch(
        trace0.ctypes.data, trace1.ctypes.data, atr,
        s_codes.ctypes.data, s_codes.shape[1],
        t_codes.ctypes.data, t_codes.shape[1],
        fin_i.ctypes.data, fin_j.ctypes.data,
        _flags_of(mode_flags), B, ops_stride,
        ops_buf.ctypes.data, ops_len.ctypes.data,
    )
    return _replayed("bst_compact_sweep_batch", rc, ops_buf, ops_len,
                     fin_i, fin_j, mode_flags)


def dna_code_map(letters: str = "ACGT", lowercase: bool = True):
    """256-entry byte -> code map for the FASTA packer (-1 = skip)."""
    m = np.full((256,), -1, np.int8)
    for i, ch in enumerate(letters):
        m[ord(ch)] = i
        if lowercase:
            m[ord(ch.lower())] = i
    return m


def fasta_pack(path: str, code_map=None):
    """Stream-parse a FASTA file into packed codes at C speed.

    Returns ``(codes int8[total], offsets int64[n], lengths int64[n],
    names list[str], header_pos int64[n])``: record r's codes are
    ``codes[offsets[r]:offsets[r] + lengths[r]]`` and ``header_pos[r]``
    is the byte offset of its ``>`` line (the DB's ``source_pos``).

    Raises ``ValueError`` if the file holds a non-whitespace sequence
    byte that ``code_map`` (256 int8 entries, -1 = unmapped; the DNA map
    by default) does not cover: skipping a letter would shift every
    later coordinate of its record.  Raises ``OSError`` if the file
    cannot be read.
    """
    lib = _load()
    if code_map is None:
        code_map = dna_code_map()
    code_map = np.ascontiguousarray(code_map, np.int8)
    if code_map.shape != (256,):
        raise ValueError("code_map must have 256 entries, got %s"
                         % (code_map.shape,))
    n = ctypes.c_int64()
    total = ctypes.c_int64()
    n_unknown = ctypes.c_int64()
    first_unknown = ctypes.c_int()
    unknown_pos = ctypes.c_int64()
    rc = lib.bst_fasta_scan(
        path.encode(), code_map.ctypes.data,
        ctypes.byref(n), ctypes.byref(total),
        ctypes.byref(n_unknown), ctypes.byref(first_unknown),
        ctypes.byref(unknown_pos),
    )
    if rc != 0:
        raise OSError("cannot read %s" % path)
    if int(n_unknown.value):
        raise ValueError(
            "letter %r not in alphabet (%d unmapped byte(s) in %s, "
            "first at file offset %d)" % (
                chr(int(first_unknown.value)), int(n_unknown.value),
                path, int(unknown_pos.value)))
    nrec = int(n.value)
    codes = np.zeros((int(total.value),), np.int8)
    offsets = np.zeros((max(nrec, 1),), np.int64)
    lengths = np.zeros((max(nrec, 1),), np.int64)
    header_pos = np.zeros((max(nrec, 1),), np.int64)
    names_cap = 1 << 20
    while True:
        names_buf = ctypes.create_string_buffer(names_cap)
        needed = ctypes.c_int64()
        got = lib.bst_fasta_pack(
            path.encode(), code_map.ctypes.data,
            codes.ctypes.data, offsets.ctypes.data, lengths.ctypes.data,
            header_pos.ctypes.data,
            names_buf, names_cap, ctypes.byref(needed),
        )
        if got != nrec:
            raise RuntimeError("bst_fasta_pack read %d records of %s, the"
                               " scan %d" % (got, path, nrec))
        if needed.value <= names_cap:
            break
        # truncated names are untrustworthy (a dropped NUL would shift
        # every later name): retry with the reported requirement
        names_cap = int(needed.value) + 1
    names = names_buf.raw.split(b"\0")[:nrec]
    return (codes, offsets[:nrec], lengths[:nrec],
            [x.decode("ascii", "replace") for x in names], header_pos[:nrec])
