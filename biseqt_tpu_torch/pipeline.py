"""Batched banded extension of candidate segments, with transcripts.

The port of :func:`biseqt_tpu.pipeline.extend_segments` (the
reference's ``pwlib`` solve + traceback contract as this framework
serves it) and of :func:`biseqt_tpu.pipeline.discover_and_extend`,
Word-Blot discovery (:mod:`.blot`) and extension in one call.  Every
candidate's (d, a) rectangle is cut out of both sequences, segments
are grouped by bucketed cutout shape, and each group is extended in
launches.  ``use_pallas``, the JAX package's engine choice, picks one
of three routes:

* ``None`` (the default) leaves it to ``device``: the antidiagonal DP
  kernel (:mod:`.ops.dp_ad`) on a card, its plain twin on the CPU.
  With transcripts each launch writes the direction plane and the walk
  kernel (:mod:`.ops.walk`, or its twin) turns it into a 2-bit op
  trace on the device.  On a card the compaction kernel
  (:mod:`.ops.compact`) then replays the trace into MSID transcript
  bytes there, and only those bytes cross to the host; on the CPU the
  C++ host tier compacts the trace (:func:`.native.compact_sweep_ops_t`),
  as on the JAX package's route on its accelerator.
* ``True`` asks for the same kernels, and so for a CUDA ``device``.
* ``False`` is the JAX package's row route, its default on a CPU: the
  row-wavefront engine (:func:`.ops.banded_dp.banded_dp`) over the
  whole band on ``device``, its ``[B, LS, W]`` direction bytes copied
  to the host and walked by the C++ tier
  (:func:`.native.traceback_batch`).  No kernel is launched.

Launch geometry (window split, cuts, shape buckets, batch padding) is
the JAX package's, so both packages solve the same problems and their
results can be compared exactly.  The per-launch cap is the card's
(:data:`LAUNCH_BYTES`); which pairs share a launch changes no result.
Launches are kept in flight under :data:`PIPELINE_BYTES`: each is
dispatched without waiting for the device, and the oldest is finished
(its results copied to the host, checked, and compacted or decoded)
while later ones run, in order, so the output does not depend on the
budget.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import native
from .blot import WordBlot
from .ops import compact
from .ops.banded_dp import ModeFlags, banded_dp, resolve_device
from .ops.dp_ad import banded_dp_ad, parity_adjusted_dmin
from .ops.walk import trace_moves, traceback_walk
from .profiling import Phase, count

__all__ = ["extend_segments", "discover_and_extend", "map_reads",
           "cut_segment", "extension_plan", "plan_launches", "launch_inputs",
           "PAD_RADIUS", "PAD_A", "DIRS_BUDGET", "LAUNCH_BYTES",
           "PIPELINE_BYTES", "launch_bytes"]

# default growth of a segment's rectangle: discovery quantizes to coarse
# cells, and the alignment must be free to extend past the seed core
PAD_RADIUS = 16   # diagonals on each side
PAD_A = 512       # antidiagonals on each end

# Per-launch budget of device memory: sequence characters plus, with
# transcripts, the dirs plane.  The JAX package's budget (4e8 bytes) was
# sized for a TPU's memory; on an 80 GB H100 it cut the smoke's group of
# 2048 10 kbp segments into five launches of K1, the last with 44 plane
# rows for most of a full launch's time.  K1's time per plane row falls
# as a launch holds more rows, past one wave of resident blocks too (on
# an H100 at W 256: 528 rows 13.3 ms, 1056 rows 23.0-23.5 ms, 2048 rows
# 42.8 ms), so memory alone caps a launch.  A tenth of the card leaves
# room for the walk's trace and the next launch's inputs.
LAUNCH_BYTES = 8 << 30
# Bytes of direction plane one transcript row may fill: a longer
# segment is split into overlapping a-windows (the JAX package's budget)
DIRS_BUDGET = 512 << 20
# Bytes the launches dispatched but not yet finished may count together
# (:func:`launch_bytes`: codes and dirs plane), as the JAX package keeps
# launches in flight under its PIPELINE_BYTES (3 GiB, a TPU's budget):
# while they run, the host copies and compacts the oldest launch's
# results.  Two full launches (2 x LAUNCH_BYTES) may be in flight, so a
# plan of 8 GiB launches still overlaps one launch's host work with the
# next one's kernels; with the launch being dispatched that is at most
# 24 GiB of the card's 80 GB, and on the host-walk route (each plane
# copied whole to pinned host memory) 16 GiB of the host's.  0 finishes
# every launch before the next is dispatched (the serial order).
PIPELINE_BYTES = 2 * LAUNCH_BYTES


def _bucket(n, mini=128):
    """Round up to a half-power-of-two grid (1M, 1.5M, 2M, 3M, ...):
    the JAX package's shape buckets for lengths, band widths and batch
    sizes."""
    n = max(int(n), 1)
    if n <= mini:
        return mini
    step = max(mini, 1 << (max(n.bit_length(), 2) - 2))
    return ((n + step - 1) // step) * step


def _split_windows(segments, pad_radius, pad_a, dirs_budget):
    """Split segments whose antidiagonal span would exceed the dirs plane
    budget into overlapping a-windows; returns the rows to extend and,
    for each, the index of the segment it came from."""
    split, src_idx = [], []
    for k, seg in enumerate(segments):
        (d_lo, d_hi), (a_lo, a_hi) = seg["segment"]
        # the same bucketing as the launch's W, so the budget bounds
        # the real plane
        W_est = _bucket(d_hi - d_lo + 1 + 2 * pad_radius, mini=128)
        max_a = max(2 * dirs_budget // W_est, 8 * pad_a)
        span = a_hi - a_lo + 1
        if span <= max_a:
            split.append(seg)
            src_idx.append(k)
            continue
        n_win = -(-span // max_a)
        step = -(-span // n_win)
        for w in range(n_win):
            lo = a_lo + w * step
            hi = min(lo + step + 2 * pad_a, a_hi)
            sub = dict(seg)
            sub["segment"] = ((d_lo, d_hi), (lo, hi))
            split.append(sub)
            src_idx.append(k)
    return split, src_idx


def extension_plan(segments, len_s, len_t, with_transcripts: bool, *,
                   pad_radius: int = PAD_RADIUS, pad_a: int = PAD_A,
                   dirs_budget: int = DIRS_BUDGET, row: bool = False):
    """What :func:`extend_segments` launches for ``segments``: ``(rows,
    src_idx, cut, launches)``, the rows after the window split
    (transcripts only), the segment each came from, each row's cut
    (:func:`cut_segment`) and the launches (:func:`plan_launches`;
    ``row``: on the row route, ``use_pallas=False``).  ``len_s`` is the
    length of S, or a sequence of one length for each segment, whose
    rows are then cut out of that segment's own S (:func:`map_reads`)."""
    if with_transcripts:
        rows, src_idx = _split_windows(segments, pad_radius, pad_a,
                                       int(dirs_budget))
    else:
        rows, src_idx = list(segments), list(range(len(segments)))
    if np.ndim(len_s) == 0:
        cut = [cut_segment(r, len_s, len_t, pad_radius, pad_a) for r in rows]
    else:
        cut = [cut_segment(r, len_s[k], len_t, pad_radius, pad_a)
               for r, k in zip(rows, src_idx)]
    return rows, src_idx, cut, plan_launches(cut, with_transcripts, row=row)


def cut_segment(seg, len_s, len_t, pad_radius=PAD_RADIUS, pad_a=PAD_A):
    """The padded (i, j) rectangle of a segment and its band relative to
    the cutouts: ``(i_lo, i_hi, j_lo, j_hi, d_lo', d_hi')``."""
    (d_lo, d_hi), (a_lo, a_hi) = seg["segment"]
    d_lo -= pad_radius
    d_hi += pad_radius
    a_lo -= pad_a
    a_hi += pad_a
    i_lo = max((a_lo + d_lo) // 2, 0)
    i_hi = min((a_hi + d_hi + 1) // 2 + 1, len_s)
    j_lo = max((a_lo - d_hi) // 2, 0)
    j_hi = min((a_hi - d_lo + 1) // 2 + 1, len_t)
    i_hi = max(i_hi, i_lo + 1)
    j_hi = max(j_hi, j_lo + 1)
    off = i_lo - j_lo
    return (i_lo, i_hi, j_lo, j_hi, d_lo - off, d_hi - off)


def _batch_mini(with_transcripts: bool) -> int:
    """The smallest bucket a launch's batch is padded to."""
    return 2 if with_transcripts else 8


def _bucket_floor(n, mini):
    """The largest bucket of :func:`_bucket`'s grid at most ``n`` (``mini``
    if none is)."""
    step = max(mini, 1 << (max(int(n).bit_length(), 2) - 2))
    return max(mini, n // step * step)


def plan_launches(cut, with_transcripts: bool, row: bool = False):
    """The launches of a list of cuts: ``(idxs, LS, LT, W)`` per launch.
    Cuts are grouped by bucketed shape, and each group is cut into
    launches whose padded batch fits the per-launch memory budget (on
    the row route, ``row``, its ``[LS, W]`` byte plane a pair).  Which
    pairs share a launch changes no result."""
    groups: Dict[tuple, List[int]] = {}
    for idx, c in enumerate(cut):
        key = (_bucket(c[1] - c[0]), _bucket(c[3] - c[2]),
               _bucket(c[5] - c[4] + 1, mini=128))
        groups.setdefault(key, []).append(idx)
    launches = []
    for (LS, LT, W), idxs in sorted(groups.items()):
        per_pair = LS + LT + 2 * W
        if with_transcripts:
            # the dirs plane dominates the launch's memory: K1's nibble
            # plane (~(LS + LT) * W / 4 bytes per pair) or the row
            # engine's byte plane (LS * W, about twice as many)
            per_pair += LS * W if row else (LS + LT + 2 * W) * W // 4
        # a launch is padded to a bucketed batch (launch_inputs): the
        # largest bucket within the budget
        cap = _bucket_floor(LAUNCH_BYTES // max(per_pair, 1),
                            _batch_mini(with_transcripts))
        for k in range(0, len(idxs), cap):
            launches.append((idxs[k:k + cap], LS, LT, W))
    return launches


def launch_inputs(cut, idxs, LS, LT, W, s_arr, t_arr,
                  with_transcripts: bool, row: bool = False):
    """The numpy inputs of one launch: the batch is padded with inert
    length-1 pairs to a bucketed size, each pair's band is the top
    ``min(width, W - 1)`` diagonals of ``[dmin, dmin + W)``, and
    ``dminq`` holds the parity-adjusted band starts the walk reads.  On
    the row route (``row``) the band is the top ``min(width, W)``
    diagonals, as the JAX package's row route has it, and there is no
    ``dminq``.  ``s_arr`` holds S's codes, or is a list of one code array
    for each row of ``cut`` (rows cut out of different S)."""
    n_pad = _bucket(len(idxs), mini=_batch_mini(with_transcripts))
    one_s = isinstance(s_arr, np.ndarray)
    s_codes = np.zeros((n_pad, LS), np.int8)
    t_codes = np.zeros((n_pad, LT), np.int8)
    s_lens = np.ones((n_pad,), np.int32)
    t_lens = np.ones((n_pad,), np.int32)
    dmin = np.zeros((n_pad,), np.int32)
    w_eff = np.ones((n_pad,), np.int32)
    for b, idx in enumerate(idxs):
        i_lo, i_hi, j_lo, j_hi, dl, dh = cut[idx]
        s_lens[b] = i_hi - i_lo
        t_lens[b] = j_hi - j_lo
        s_codes[b, : s_lens[b]] = (s_arr if one_s else s_arr[idx])[i_lo:i_hi]
        t_codes[b, : t_lens[b]] = t_arr[j_lo:j_hi]
        # pad on the dmin side to the shared W (the lane mask trims it)
        dmin[b] = dh - W + 1
        w_eff[b] = min(dh - dl + 1, W)
    x = dict(s_codes=s_codes, t_codes=t_codes, s_lens=s_lens,
             t_lens=t_lens, dmin=dmin, w_eff=w_eff)
    if row:
        return x
    # one lane of slack absorbs the parity adjustment of dmin
    x["w_eff"] = np.minimum(w_eff, W - 1)
    x["dminq"] = parity_adjusted_dmin(dmin,
                                      np.arange(n_pad, dtype=np.int32) % 2)
    return x


def _engine_device(use_pallas, device):
    """``(device, row)``: ``device`` resolved, and whether
    ``use_pallas``, the JAX package's engine choice, names the row route.
    ``True`` asks for the kernels and raises ``ValueError`` unless
    ``device`` is a card; ``None`` leaves the choice to ``device`` (the
    kernels on a card, their plain twins on the CPU); ``False`` names
    the row route, which runs on any ``device``.  Work never moves to
    another device than ``device``."""
    device = resolve_device(device)
    if use_pallas and device.type != "cuda":
        raise ValueError(
            "use_pallas=%r contradicts device=%s: the kernels run on a"
            " CUDA device" % (use_pallas, device))
    return device, use_pallas is not None and not use_pallas


def launch_bytes(n, LS, LT, W, with_transcripts: bool, r_chunk: int = 128,
                 row: bool = False):
    """The bytes a launch of ``n`` pairs counts against
    :data:`PIPELINE_BYTES`: its padded codes and, with transcripts, its
    dirs plane, K1's ``[Apad // 2, B2, W]`` or on the row route
    (``row``) the row engine's ``[n_pad, LS, W]``."""
    n_pad = _bucket(n, mini=_batch_mini(with_transcripts))
    est = n_pad * (LS + LT)
    if with_transcripts and row:
        est += n_pad * LS * W
    elif with_transcripts:
        apad = -(-(LS + LT + 2) // r_chunk) * r_chunk
        est += apad // 2 * ((n_pad + 1) // 2) * W
    return est


def _to_host(x, device):
    """A host copy of ``x`` started on the current stream and not waited
    for: a pinned buffer on a card (read it once the launch's event has
    completed), ``x`` itself on the CPU."""
    if device.type != "cuda":
        return x
    count("bytes_to_host.pinned", x.numel() * x.element_size())
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x, non_blocking=True)


class _Launch(NamedTuple):
    """A dispatched launch: its rows, its inputs, its band width, its
    route (see :func:`_dispatch`), the host copies of its results (ready
    once ``event`` has completed; ``None`` on the CPU)."""
    idxs: list
    x: dict
    W: int
    route: str
    host: list
    event: Optional[torch.cuda.Event]


def _dispatch(idxs, x, W, dp_kw, with_transcripts, route, device):
    """Queue one launch on the device, then the copies of what
    :func:`_finish` reads to pinned host buffers, then an event; nothing
    here waits for the device.  ``route``: ``"walk"``, K1 and with
    transcripts the walk kernel, its replay guard and the compaction of
    its trace on the device; ``"trace"``, the same with the trace itself
    copied (for the C++ tier); ``"plane"``, K1 and its plane; ``"row"``,
    the row engine and its first ``n`` pairs' byte plane."""
    n = len(idxs)
    args = (x["s_codes"], x["t_codes"], x["s_lens"], x["t_lens"], x["dmin"])
    kw = dict(W=W, w_eff=x["w_eff"], with_dirs=with_transcripts,
              device=device, **dp_kw)
    if route == "row":
        res = banded_dp(*args, **kw)
    else:
        res, codes = banded_dp_ad(*args, return_codes=True, **kw)
    host = [res.score[:n]]
    if with_transcripts and route in ("walk", "trace"):
        # padding pairs are skipped by the walk (-1 end cells)
        real = torch.arange(len(x["dmin"]), device=device) < n
        ei = torch.where(real, res.end_i, -1)
        ej = torch.where(real, res.end_j, -1)
        trace, fi, fj = traceback_walk(res.dirs, x["dminq"], ei, ej, W=W,
                                       device=device)
        if route == "walk":
            # the transcripts, their lengths and the trace's moves, from
            # the letters K1 read on the device
            ops, ops_len, di, dj = compact.compact(trace, fi, fj, *codes,
                                                   dp_kw["flags"])
            walked, extra = ops[:n], [ops_len]
        else:
            di, dj = trace_moves(trace, len(ei))
            walked, extra = trace, []
        # every walk must move from its end cell to its start cell by its
        # trace's ops: checked on the device, copied with the cursors
        bad = ((ei - fi) != di) | ((ej - fj) != dj)
        host += [torch.stack([fi, fj, di, dj, bad.to(torch.int32), *extra]),
                 walked]
    elif with_transcripts:
        plane = res.dirs[:n] if route == "row" else res.dirs
        host += [torch.stack([res.end_i[:n], res.end_j[:n]]), plane]
    host = [_to_host(h, device) for h in host]
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return _Launch(idxs, x, W, route, host, event)


def _finish(launch, flags, with_transcripts):
    """Wait for a dispatched launch and return its scores and, with
    transcripts, its ``(ops, start_i, start_j)``: decoded from the
    device's compaction, or compacted or walked by the C++ tier; a walk
    that does not lead from its end cell raises."""
    with Phase("pipeline.wait"):
        if launch.event is not None:
            launch.event.synchronize()
    x, n = launch.x, len(launch.idxs)
    score = launch.host[0].numpy()
    if not with_transcripts:
        return score, None
    # the walk's cursors and transcript bytes or trace, or the end cells
    # and the plane
    cursors, walked = (h.numpy() for h in launch.host[1:])
    codes = (x["s_codes"][:n], x["t_codes"][:n], x["s_lens"][:n],
             x["t_lens"][:n])
    with Phase("pipeline.compact"):
        if launch.route == "row":
            # lane k of the row plane is the diagonal dmin + W - 1 - k
            return score, native.traceback_batch(
                walked, x["dmin"][:n] + (launch.W - 1), *codes, *cursors,
                flags)
        if launch.route == "plane":
            return score, native.traceback_batch_ad(
                walked, x["dminq"][:n], *codes, *cursors, flags)
        fi, fj, di, dj, bad = cursors[:5]
        if bad.any():
            raise RuntimeError(
                "the walk's trace does not lead from the end cells to its"
                " final cursors for pairs %s of the launch of rows %s"
                % (np.nonzero(bad)[0][:8].tolist(),
                   list(launch.idxs)[:8]))
        if launch.route == "trace":
            return score, native.compact_sweep_ops_t(
                walked, fi, fj, *codes, flags, moves=(di[:n], dj[:n]))
        # the transcripts compacted on the device: checked and decoded
        return score, compact.transcripts(
            walked, cursors[5][:n], fi[:n], fj[:n], (di[:n], dj[:n]),
            codes[2], codes[3], flags)


def extend_segments(S, T, segments: List[Dict], *, subst=None,
                    go_score=-3.0, ge_score=-1.0, use_pallas: bool = None,
                    pad_radius: int = PAD_RADIUS, pad_a: int = PAD_A,
                    with_transcripts: bool = False, device_walk: bool = True,
                    device="cuda", _dirs_budget: int = DIRS_BUDGET,
                    _r_chunk: int = 128):
    """Batched banded extension of candidate segments.

    ``S`` / ``T``: sequences (anything with ``to_array()`` and ``len``);
    ``segments``: dicts with ``"segment": ((d_lo, d_hi), (a_lo, a_hi))``
    as Word-Blot discovery emits them.  Each segment's rectangle, grown
    by ``pad_radius`` diagonals and ``pad_a`` antidiagonals, is aligned
    in local mode.  Returns the segments with ``score``, ``band_cells``
    and ``source_index`` (position in ``segments``) attached; with
    ``with_transcripts`` also ``transcript`` (MSID string) and
    ``origin_start`` / ``mutate_start`` (coordinates in the full S / T).
    In transcript mode a segment whose antidiagonal span exceeds the
    direction-plane budget is split into overlapping windows, so the
    output may hold more rows than ``segments``: join on
    ``source_index``.

    ``device="cuda"`` (the default) runs on the card and raises without
    one; ``device="cpu"`` runs on the host.  ``use_pallas`` picks the
    route, as in the JAX package: ``None`` (the default) the
    hand-written kernels on a card and their plain PyTorch twins on the
    CPU; ``True`` the kernels, and raises ``ValueError`` unless
    ``device`` is a card; ``False`` the JAX package's row route on
    ``device`` (the row-wavefront engine over the whole band, its
    direction bytes walked on the host by
    :func:`.native.traceback_batch`), which launches no kernel.  With
    ``device_walk=False`` K1's direction plane is copied to the host and
    walked there by the C++ tier (:func:`.native.traceback_batch_ad`),
    the JAX package's host route; its transcripts and start cells equal
    the device walk's.  The row route always walks on the host, so
    ``device_walk`` has no effect there, as in the JAX package.
    """
    device, row = _engine_device(use_pallas, device)
    if not segments:
        return []
    return _extend(S.to_array(), len(S), T, segments, subst=subst,
                   go_score=go_score, ge_score=ge_score, row=row,
                   device=device, device_walk=device_walk,
                   with_transcripts=with_transcripts, pad_radius=pad_radius,
                   pad_a=pad_a, dirs_budget=_dirs_budget, r_chunk=_r_chunk)


def _extend(s_arr, len_s, T, segments, *, subst, go_score, ge_score, device,
            with_transcripts, row=False, device_walk=True,
            pad_radius=PAD_RADIUS, pad_a=PAD_A, dirs_budget=DIRS_BUDGET,
            r_chunk=128):
    """The body of :func:`extend_segments`: ``s_arr`` / ``len_s`` are S's
    codes and length, or lists of one code array and one length for each
    segment (:func:`map_reads`)."""
    A = len(T.alphabet)
    t_arr = T.to_array()
    if subst is None:
        subst = np.where(np.eye(A, dtype=bool), 1.0, -1.0).astype(np.float32)
    subst = np.asarray(subst, np.float32)

    # on a card the walk's trace is compacted there, on the CPU by the C++
    # tier
    route = ("row" if row else "plane" if not device_walk
             else "walk" if device.type == "cuda" else "trace")
    if with_transcripts and route != "walk":
        # the C++ tier walks or compacts these routes' transcripts: fail
        # before any launch when it is missing
        if not native.available():
            raise RuntimeError(
                "extend_segments(with_transcripts=True) compacts op "
                "traces with the native C++ tier, which is unavailable "
                "(building biseqt_tpu_torch/csrc/pwnative.cpp failed — is a "
                "C++ toolchain installed?); run score-only "
                "(with_transcripts=False)")
    with Phase("pipeline.plan"):
        segments, src_idx, cut, launches = extension_plan(
            segments, len_s, len(T), with_transcripts,
            pad_radius=pad_radius, pad_a=pad_a, dirs_budget=dirs_budget,
            row=row)
        if not isinstance(s_arr, np.ndarray):
            # each row's S: its segment's
            s_arr = [s_arr[k] for k in src_idx]
    B = len(cut)
    # local mode: the alignment starts and ends wherever the homology does
    flags = ModeFlags(local_start=True, local_end=True)
    scores = np.zeros((B,), np.float32)
    ops = [""] * B
    si_all = np.zeros((B,), np.int32)
    sj_all = np.zeros((B,), np.int32)
    dp_kw = dict(subst=subst, go=float(go_score), ge=float(ge_score),
                 flags=flags)
    if not row:
        dp_kw["r_chunk"] = int(r_chunk)

    total_cells = sum(
        int(c[5] - c[4] + 1) * int(c[1] - c[0]) for c in cut)
    # launches in flight, oldest first, and the bytes they count
    pending, inflight = deque(), 0

    def finish_oldest():
        nonlocal inflight
        launch, est = pending.popleft()
        inflight -= est
        with Phase("pipeline.finish"):
            score, walked = _finish(launch, flags, with_transcripts)
        idxs = launch.idxs
        scores[idxs] = score
        if walked is not None:
            for b, idx in enumerate(idxs):
                ops[idx] = walked[0][b]
                si_all[idx] = walked[1][b]
                sj_all[idx] = walked[2][b]

    with Phase("pipeline.extend", cells=total_cells):
        for idxs, LS, LT, W in launches:
            est = launch_bytes(len(idxs), LS, LT, W, with_transcripts,
                               int(r_chunk), row=row)
            # finish the oldest launches first while this one would put
            # the bytes in flight past the budget (0: one at a time)
            while pending and inflight + est > PIPELINE_BYTES:
                finish_oldest()
            with Phase("pipeline.gather"):
                x = launch_inputs(cut, idxs, LS, LT, W, s_arr, t_arr,
                                  with_transcripts, row=row)
            with Phase("pipeline.launch"):
                pending.append((_dispatch(idxs, x, W, dp_kw,
                                          with_transcripts, route, device),
                                est))
            inflight += est
        while pending:
            finish_oldest()

    with Phase("pipeline.rows"):
        out = []
        for b, seg in enumerate(segments):
            seg = dict(seg)
            seg["source_index"] = src_idx[b]
            seg["score"] = float(scores[b])
            seg["band_cells"] = int(
                (cut[b][5] - cut[b][4] + 1) * (cut[b][1] - cut[b][0]))
            if with_transcripts:
                seg["transcript"] = ops[b]
                seg["origin_start"] = int(cut[b][0] + si_all[b])
                seg["mutate_start"] = int(cut[b][2] + sj_all[b])
            out.append(seg)
    return out


def discover_and_extend(S, T, *, wordlen: int = 8, K_min: int = 100,
                        p_min: float = 0.6, g_max: float = 0.2, subst=None,
                        go_score=-3.0, ge_score=-1.0, use_pallas: bool = None,
                        with_transcripts: bool = False, device="cuda"):
    """Word-Blot discovery + batched banded extension, one call.

    Returns the discovered segments with their DP ``score`` (plus the
    MSID ``transcript`` and start coordinates with ``with_transcripts``),
    sorted by score, highest first.  In transcript mode a segment longer
    than the direction plane's budget comes back as several a-windows:
    join on ``source_index``.

    ``device="cuda"`` (the default) runs the seed join and statistics on
    the card, ``"cpu"`` on the host, and the extension on the same
    device.  ``use_pallas``, the JAX package's engine choice, picks the
    extension's route as in :func:`extend_segments`: ``None`` the
    hand-written kernels on a card and their plain twins on the CPU,
    ``True`` the kernels (a CUDA ``device``, else ``ValueError``),
    ``False`` the row route on ``device``.
    """
    device, _ = _engine_device(use_pallas, device)
    wb = WordBlot(S, T, wordlen=wordlen, g_max=g_max, device=device)
    segments = list(wb.similar_segments(K_min=K_min, p_min=p_min))
    extended = extend_segments(
        S, T, segments, subst=subst, go_score=go_score, ge_score=ge_score,
        use_pallas=use_pallas, with_transcripts=with_transcripts,
        device=device)
    return sorted(extended, key=lambda s: -s["score"])


def map_reads(mapper, reads, *, K_min: int, p_min: float, subst=None,
              go_score=-3.0, ge_score=-1.0, with_transcripts: bool = False,
              device="cuda"):
    """Read mapping to a fixed reference: each read's similar segments,
    and its best segment extended against the reference.

    ``mapper``: a :class:`.blot.WordBlotLocalRef` over the reference (T);
    ``reads``: sequences (S), the same alphabet.  Discovery is one
    :meth:`~.blot.WordBlotLocalRef.similar_segments_batch` call.  A read's
    best segment is the one with the most seeds (the first in discovery
    order on a tie).  All reads' best segments are extended in one
    extension: rows of different reads share a launch wherever their
    bucketed shapes match, and each row equals the row that
    ``extend_segments(read, mapper.ref, [best], ...)`` gives for that read
    alone (so its ``source_index`` is 0).

    Returns one dict a read: ``segments`` (as the discovery gives them),
    ``best`` (the index of the best segment among them, None for a read
    with no segment) and ``rows`` (the extension rows of the best
    segment; none for an unmapped read).  ``device`` names the mapper's
    device (``"cuda"`` by default, raising without a card), where the
    call runs; a mapper on another device raises ``ValueError``.
    """
    device = resolve_device(device)
    if mapper.device != device:
        raise ValueError("map_reads(device=%s) got a mapper on %s"
                         % (device, mapper.device))
    reads = list(reads)
    with Phase("map.discover"):
        count("map.reads", len(reads))
        found = mapper.similar_segments_batch(reads, K_min, p_min)
        best = [max(range(len(segs)), key=lambda k: segs[k]["num_seeds"])
                if segs else None for segs in found]
        count("map.unmapped", best.count(None))
    mapped = [q for q, b in enumerate(best) if b is not None]
    out = [{"segments": segs, "best": b, "rows": []}
           for segs, b in zip(found, best)]
    if not mapped:
        return out
    with Phase("map.extend"):
        rows = _extend([reads[q].to_array() for q in mapped],
                       [len(reads[q]) for q in mapped], mapper.ref,
                       [found[q][best[q]] for q in mapped], subst=subst,
                       go_score=go_score, ge_score=ge_score, device=device,
                       with_transcripts=with_transcripts)
    for r in rows:
        # the row of the read's own extension of its one best segment
        out[mapped[r["source_index"]]]["rows"].append(
            dict(r, source_index=0))
    return out
