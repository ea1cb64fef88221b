"""Antidiagonal dual-pair banded affine-gap DP: CUDA kernel + plain twin.

The port of :mod:`biseqt_tpu.ops.pallas_dp_ad` (TPU kernel ``_kernel``,
public ``banded_dp_pallas_ad``).  The DP sweeps antidiagonals
``a = i + j``; lane ``k`` of a plane row holds diagonal
``d = dmin' + k``, so every predecessor lives in an earlier wavefront:
diag (i-1, j-1) on the same lane two steps back, E-pred (i, j-1) on
lane k+1 and F-pred (i-1, j) on lane k-1 one step back.  Cell (i, j)
exists on lane k only when ``(a + k)`` has the parity of ``dmin'``, so
plane row ``b2`` hosts two pairs, ``2 b2`` and ``2 b2 + 1``, on the
complementary parity sublattices: pair p's band start is adjusted up to
``dmin' ≡ p (mod 2)`` (:func:`parity_adjusted_dmin`).

The contract is held byte for byte with the JAX package:

* scores, and with ``with_dirs`` the end cells, equal the reference's;
* the direction plane is row-major ``[Apad // 2, B2, W]`` uint8 with
  ``Apad = round_up(LS + LT + 2, r_chunk)``: cell (i, j) of pair p sits
  at byte row ``a // 2``, column ``p // 2``, lane
  ``x = (i - j) - dmin'_p``, low nibble for even ``a``.  Nibble bits:
  0-1 H source (0 stop, 1 diag, 2 E, 3 F), bit 2 E-extend, bit 3
  F-extend.  The walk (:mod:`.walk`) and the C++ host walker
  (``native.traceback_batch_ad``) read this plane.

Both engines below run the reference's drifted arithmetic step for
step — carried values are ``H + gd * a`` with ``gd = -ge``, the
substitution constants absorb ``+2 gd``, trackers drift ``+2 gd`` per
update and are un-drifted at the end, and the scalar drift ``ga`` of
step ``a`` is ``f32(a // R) * f32(R * gd) + f32(gd * (a % R))`` with
``R = r_chunk`` — because direction nibbles come from float EQUALITY
tests and any other rounding flips ties.

:func:`banded_dp_ad` launches the CUDA kernel (``csrc/dp_ad.cu``) on
CUDA and runs the plain PyTorch twin :func:`banded_dp_ad_reference`
on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..profiling import Phase, count
from .banded_dp import NEG, DPResult, ModeFlags, on_device, resolve_device
from .steps import put, run_steps, take

__all__ = ["banded_dp_ad", "banded_dp_ad_reference", "parity_adjusted_dmin",
           "live_nibbles", "cluster", "MAX_W", "MAX_A"]

PAD_S = -1        # s pad code (never equals a t code)
PAD_T = -2
# the widest band the kernel takes: above 4096 lanes a plane row is a
# thread-block cluster of at most 16 blocks of 4096 lanes; above
# PORTABLE_W (8 blocks, the portable cluster size) the wrapper first asks
# the card whether it holds such a cluster
MAX_W = 65536
PORTABLE_W = 32768
MAX_A = 127       # letter codes are int8, the pads -1 and -2
# the routes that take any W
WIDE_ROUTES = ("extend_segments(use_pallas=False) (the row route) or"
               " parallel.band_sharded_ad_traceback")

_NEGF = np.float32(NEG)

# the mangled-name stem of the kernel instance that the main path
# launches (extend_segments: W <= 1024, local mode with directions:
# dp_ad_kernel<1, false, MAIN_MODE, false>), to find it in the SASS
MAIN_KERNEL = "dp_ad_kernelILi1ELb0ELi26ELb0EE"


def parity_adjusted_dmin(dmin, pair_index):
    """The per-pair band start ``dmin'`` (``dmin`` adjusted upward so
    ``dmin' ≡ pair (mod 2)``) — the lane addressing of the dirs plane.
    Works on numpy arrays and tensors alike."""
    return dmin + (pair_index - dmin) % 2


def live_nibbles(dmin: torch.Tensor, w_eff: torch.Tensor, W: int):
    """Masks ``(low, high)``, bool [B2, W], of the live slots of a dirs
    plane row.  The low nibble (even step) of lane x belongs to pair
    ``2 b2 + x % 2``, the high nibble to pair ``2 b2 + (x + 1) % 2``, and
    a pair's slots are live on lanes ``[lo, hi)``: its top
    ``min(w_eff, W - 1)`` diagonals after the parity adjustment.  Other
    slots hold bytes no walk reads."""
    dev = dmin.device
    B = dmin.shape[0]
    B2 = (B + 1) // 2
    pad = 2 * B2 - B
    dmin = torch.cat([dmin.long(), dmin.new_zeros(pad, dtype=torch.long)])
    w_eff = torch.cat([w_eff.long().clamp(max=W - 1),
                       w_eff.new_ones(pad, dtype=torch.long)])
    up = parity_adjusted_dmin(dmin, torch.arange(2 * B2, device=dev) % 2) \
        - dmin
    lo, hi = W - up - w_eff, W - up
    x = torch.arange(W, device=dev)[None, :]
    pair = 2 * torch.arange(B2, device=dev)[:, None]
    live = lambda p: (x >= lo[p]) & (x < hi[p])
    return live(pair + x % 2), live(pair + (x + 1) % 2)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _subst_table(subst, gd: float):
    """Drifted substitution table ``[A, A]`` and drifted pad score, as
    the reference forms them: the uniform path (one match and one
    negative mismatch value) scores pads as a mismatch and rounds
    ``m + 2 gd`` in double; the general path adds ``f32(2 gd)`` to each
    f32 entry and scores pads ``-1 + 2 gd``."""
    subst = np.asarray(subst, np.float32)
    A = subst.shape[0]
    if subst.shape != (A, A):
        raise ValueError("subst must be square, got %s" % (subst.shape,))
    diag = np.diag(subst)
    off = subst[~np.eye(A, dtype=bool)]
    if (np.allclose(diag, diag[0])
            and (off.size == 0 or np.allclose(off, off[0]))):
        m = float(diag[0])
        mm = float(off[0]) if off.size else 0.0
        if mm < 0:
            table = np.where(np.eye(A, dtype=bool), np.float32(m + 2.0 * gd),
                             np.float32(mm + 2.0 * gd)).astype(np.float32)
            return table, np.float32(mm + 2.0 * gd)
    table = (subst + np.float32(2.0 * gd)).astype(np.float32)
    return table, np.float32(-1.0 + 2.0 * gd)


def _extent(x):
    """``(min, max)`` of ``x`` as ints: on the host for a numpy array or
    list, on its device (a wait for it) for a tensor."""
    if isinstance(x, torch.Tensor):
        return (int(x.min()), int(x.max())) if x.numel() else (0, 0)
    x = np.asarray(x)
    return (int(x.min()), int(x.max())) if x.size else (0, 0)


def _geometry(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, *, W, subst,
              go, ge, r_chunk, device):
    """Pad the batch to whole plane rows and derive the per-pair lane
    geometry and the f32 constants both engines use."""
    if W < 2 or W % 2 or (W > 2048 and W % 4) or (W > 4096 and W % 128):
        raise ValueError("W must be even, at least 2, a multiple of 4 above"
                         " 2048 and of 128 above 4096, got %d" % W)
    if not (go <= 0 and ge <= 0):
        raise ValueError("the kernel requires nonpositive gap scores")
    if r_chunk < 2 or r_chunk % 2:
        raise ValueError("r_chunk must be a positive even number")
    # checked before the copy: numpy inputs on the host, so that a launch
    # from host arrays waits for no earlier work on the card
    lens_lo, lens_hi = zip(*map(_extent, (s_lens, t_lens)))
    code_hi = max(_extent(s_codes)[1], _extent(t_codes)[1])
    s_codes = on_device(s_codes, torch.int8, device)
    t_codes = on_device(t_codes, torch.int8, device)
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    if t_codes.shape[0] != B:
        raise ValueError("s_codes and t_codes disagree on the batch")
    i32 = lambda x: on_device(x, torch.int32, device).reshape(B)
    s_lens, t_lens, dmin = i32(s_lens), i32(t_lens), i32(dmin)
    if w_eff is None:
        w_eff = torch.full((B,), W - 1, dtype=torch.int32, device=device)
    w_eff = i32(w_eff).clamp(max=W - 1)
    if B and (min(lens_lo) < 0 or lens_hi[0] > LS or lens_hi[1] > LT):
        raise ValueError("sequence lengths outside [0, LS] / [0, LT]")

    B2 = (B + 1) // 2
    Bp = 2 * B2
    pad = Bp - B

    def padb(x, fill):
        return torch.cat([x, x.new_full((pad,), fill)]) if pad else x

    if pad:
        s_codes = torch.cat([s_codes, s_codes.new_full((pad, LS), PAD_S)])
        t_codes = torch.cat([t_codes, t_codes.new_full((pad, LT), PAD_T)])
    s_lens_p, t_lens_p = padb(s_lens, 1), padb(t_lens, 1)
    dmin_p, weff_p = padb(dmin, 0), padb(w_eff, 1)
    pair_id = torch.arange(Bp, dtype=torch.int32, device=device) % 2
    dminq = parity_adjusted_dmin(dmin_p, pair_id)
    up = dminq - dmin_p
    # the effective band is the TOP w_eff diagonals: live lanes [lo, hi)
    lo = W - up - weff_p
    hi = W - up

    gd = -float(ge)
    table, pad_sub = _subst_table(subst, gd)
    A = table.shape[0]
    if A > MAX_A:
        raise ValueError("alphabets above %d letters do not fit the int8"
                         " letter codes" % MAX_A)
    # the kernel indexes its shared-memory table with the codes
    if B and code_hi >= A:
        raise ValueError("letter codes must lie below the alphabet size %d"
                         % A)
    Apad = _round_up(LS + LT + 2, r_chunk)
    return dict(
        B=B, B2=B2, LS=LS, LT=LT, W=W, Apad=Apad, R=int(r_chunk),
        s_codes=s_codes.contiguous(), t_codes=t_codes.contiguous(),
        s_lens_in=s_lens, t_lens_in=t_lens,
        s_lens=s_lens_p.contiguous(), t_lens=t_lens_p.contiguous(),
        dminq=dminq.contiguous(), lo=lo.contiguous(), hi=hi.contiguous(),
        table=on_device(table, torch.float32, device), pad_sub=pad_sub,
        gd=gd, go=np.float32(go), two_gd=np.float32(2.0 * gd),
        rgd=np.float32(r_chunk * gd),
        undrift_a=np.float32(gd * (Apad - 2)),
        undrift_b=np.float32(gd * (Apad - 1)),
    )


def _ga(a: int, g) -> np.float32:
    """The drifted zero of step ``a``, rounded exactly as the reference
    forms it from its chunk index and in-chunk step (and 0 when there is
    no drift)."""
    R = g["R"]
    ga0 = np.float32(a // R) * g["rgd"] if g["gd"] else np.float32(0.0)
    return np.float32(ga0) + np.float32(g["gd"] * (a % R))


def _sweep_plain(g, flags: ModeFlags, with_dirs: bool):
    """The plain PyTorch engine: one vectorised [B2, W] update per
    antidiagonal, in the reference's order of float operations (on a
    card replayed from CUDA graphs, :func:`.steps.run_steps`).
    Returns un-drifted per-lane maxima ``(Ma, Mb)`` of even / odd
    steps, their step-of-max ``(Aa, Ab)`` and the dirs plane."""
    dev = g["s_codes"].device
    W, B2, Apad = g["W"], g["B2"], g["Apad"]
    f32 = lambda v: torch.tensor(np.float32(v), device=dev)
    NEGT = f32(_NEGF)
    ZERO = f32(0.0)
    k = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    even_k = (k % 2) == 0
    col = lambda x: x.reshape(B2, 2)
    dq, lo, hi = col(g["dminq"]), col(g["lo"]), col(g["hi"])
    sl, tl = col(g["s_lens"]), col(g["t_lens"])
    dq0, dq1 = dq[:, :1], dq[:, 1:]
    sl0, sl1, tl0, tl1 = sl[:, :1], sl[:, 1:], tl[:, :1], tl[:, 1:]
    okf = [torch.where((k >= lo[:, p:p + 1]) & (k < hi[:, p:p + 1]),
                       ZERO, NEGT) for p in (0, 1)]
    lane_okf = (torch.where(even_k, okf[0], okf[1]),     # a even
                torch.where(even_k, okf[1], okf[0]))     # a odd
    wrapmask_E = torch.where(k == W - 1, NEGT, ZERO)
    wrapmask_F = torch.where(k == 0, NEGT, ZERO)
    sltl0, sltl1 = sl0 + tl0, sl1 + tl1
    kc0, kc1 = sl0 - tl0 - dq0, sl1 - tl1 - dq1

    # per step parity: slot (a, k) belongs to pair p = (a + k) % 2
    rows = torch.arange(B2, dtype=torch.int64, device=dev)[:, None]
    slot = []
    for par in (0, 1):
        p = ((k + par) % 2).to(torch.int64)
        pair = 2 * rows + p
        slot.append(dict(pair=pair, dq=g["dminq"][pair],
                         sl=g["s_lens"][pair], tl=g["t_lens"][pair]))
    s_flat = g["s_codes"].reshape(-1).to(torch.int64)
    t_flat = g["t_codes"].reshape(-1).to(torch.int64)
    LS, LT = g["LS"], g["LT"]
    table = g["table"].reshape(-1)
    A = g["table"].shape[0]
    pad_sub = f32(g["pad_sub"])
    go, two_gd = f32(g["go"]), f32(g["two_gd"])

    def sub_at(a, at):
        sd = slot[a % 2]
        i = (at + sd["dq"] + k) // 2
        j = (at - sd["dq"] - k) // 2
        si, tj = i - 1, j - 1
        s_ok = (si >= 0) & (si < sd["sl"])
        t_ok = (tj >= 0) & (tj < sd["tl"])
        sc = torch.where(s_ok, s_flat[sd["pair"] * LS + si.clamp(0, LS - 1)],
                         PAD_S)
        tc = torch.where(t_ok, t_flat[sd["pair"] * LT + tj.clamp(0, LT - 1)],
                         PAD_T)
        val = table[sc.clamp(min=0) * A + tc.clamp(min=0)]
        return torch.where((sc < 0) | (tc < 0), pad_sub, val)

    shape = (B2, W)
    neg = torch.full(shape, float(_NEGF), device=dev)
    if not (flags.local_start or flags.free_start_edges):
        # corner seed: H(0, 0) = 0 through H2 = -sub(0, 0)
        H2 = torch.where((k == -dq0) | (k == -dq1), -pad_sub, NEGT)
    else:
        H2 = neg.clone()
    H1, E, F = neg.clone(), neg.clone(), neg.clone()
    dirs = (torch.empty((Apad // 2, B2, W), dtype=torch.uint8, device=dev)
            if with_dirs else None)
    track_local = flags.local_end
    track_rays = flags.free_end_edges
    # the drifted zero of every step, made on the host once: a scalar
    # copied to the card per step would wait for the queue each time
    ga_all = torch.tensor(np.array([_ga(a, g) for a in range(Apad)],
                                   np.float32), device=dev)

    def step(a, at, state):
        """Antidiagonal ``a`` (its parities from the int ``a``, the rest
        from ``at``)."""
        H2, H1, E, F, M0, M1, A0, A1, nib = state
        M, Ast = [M0, M1], [A0, A1]
        sub = sub_at(a, at)
        ga = take(ga_all, at)
        HpGo = H1 + go
        if with_dirs:
            e4 = torch.roll(torch.where(E >= HpGo, 4, 0), -1, 1)
            f8 = torch.roll(torch.where(F >= HpGo, 8, 0), 1, 1)
        E = torch.roll(torch.maximum(HpGo, E), -1, 1) + wrapmask_E
        F = torch.roll(torch.maximum(HpGo, F), 1, 1) + wrapmask_F
        diag_cand = H2 + sub
        H_new = torch.maximum(torch.maximum(diag_cand, E), F)
        if flags.local_start:
            H_new = torch.maximum(H_new, ga)
        if flags.free_start_edges:
            ray = ((k == (-dq0 - at)) | (k == (at - dq0))
                   | (k == (-dq1 - at)) | (k == (at - dq1)))
            H_new = torch.maximum(H_new, torch.where(ray, ga, NEGT))
        if with_dirs:
            d = torch.where(H_new == diag_cand, 1,
                            torch.where(H_new == E, 2, 3))
            if flags.local_start:
                d = torch.where((H_new == ga) & (diag_cand < ga), 0, d)
            byte = d + e4 + f8
            if a % 2 == 0:
                nib = byte
            else:
                put(dirs, at // 2, (nib + 16 * byte).to(torch.uint8))
        H_new = H_new + lane_okf[a % 2]
        if track_local:
            tracked = H_new
        elif track_rays:
            cond = (((k == (2 * sl0 - dq0 - at)) & (at >= sl0)
                     & (at <= sltl0))
                    | ((k == (at - dq0 - 2 * tl0)) & (at >= tl0)
                       & (at <= sltl0))
                    | ((k == (2 * sl1 - dq1 - at)) & (at >= sl1)
                       & (at <= sltl1))
                    | ((k == (at - dq1 - 2 * tl1)) & (at >= tl1)
                       & (at <= sltl1)))
            tracked = torch.where(cond, H_new, NEGT)
        else:
            cond = (((at == sltl0) & (k == kc0))
                    | ((at == sltl1) & (k == kc1)))
            tracked = torch.where(cond, H_new, NEGT)
        # trackers drift +2 gd per own update so maxima across steps
        # compare drift-consistently
        Ms = M[a % 2] + two_gd
        if with_dirs:
            Ast[a % 2] = torch.where(tracked > Ms, at, Ast[a % 2]).to(
                torch.int32)
        M[a % 2] = torch.maximum(Ms, tracked)
        return (H1, H_new, E, F, M[0], M[1], Ast[0], Ast[1], nib)

    Ast0 = torch.full(shape, -1, dtype=torch.int32, device=dev)
    state = (H2, H1, E, F, neg.clone(), neg.clone(), Ast0, Ast0.clone(),
             torch.zeros(shape, dtype=torch.int64, device=dev))
    _, _, _, _, M0, M1, A0, A1, _ = run_steps(step, state, range(Apad))
    M = [M0, M1]
    Ast = [A0, A1]
    Ma = M[0] - f32(g["undrift_a"])
    Mb = M[1] - f32(g["undrift_b"])
    return Ma, Mb, Ast[0], Ast[1], dirs


def _sweep_cuda(g, flags: ModeFlags, with_dirs: bool):
    """Launch ``csrc/dp_ad.cu`` on the current stream; same outputs as
    :func:`_sweep_plain`."""
    from .. import _build
    from ..native import _flags_of

    dev = g["s_codes"].device
    W, B2, Apad = g["W"], g["B2"], g["Apad"]
    if W > MAX_W:
        raise ValueError(
            "the kernel takes bands of up to MAX_W = %d lanes (a cluster of"
            " 16 blocks), got W %d; wider bands run on %s"
            % (MAX_W, W, WIDE_ROUTES))
    if W > PORTABLE_W:
        blocks, _, held = cluster(W, g["table"].shape[0], with_dirs, dev)
        if held < 1:
            raise ValueError(
                "W %d needs a cluster of %d blocks, which this card cannot"
                " hold; it runs up to PORTABLE_W = %d lanes, wider bands on"
                " %s" % (W, blocks, PORTABLE_W, WIDE_ROUTES))
    lib = _build.load("dp_ad", _declare)
    Ma = torch.empty((B2, W), dtype=torch.float32, device=dev)
    Mb = torch.empty_like(Ma)
    Aa = torch.empty((B2, W), dtype=torch.int32, device=dev)
    Ab = torch.empty_like(Aa)
    dirs = (torch.empty((Apad // 2, B2, W), dtype=torch.uint8, device=dev)
            if with_dirs else None)
    table = g["table"].to(torch.float32).contiguous()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    f = ctypes.c_float
    rc = lib.bst_dp_ad(
        ptr(g["s_codes"]), ptr(g["t_codes"]), ptr(g["s_lens"]),
        ptr(g["t_lens"]), ptr(g["dminq"]), ptr(g["lo"]), ptr(g["hi"]),
        ptr(table), table.shape[0], f(g["pad_sub"]),
        B2, g["LS"], g["LT"], W, Apad, g["R"], _flags_of(flags),
        f(g["go"]), f(g["two_gd"]), f(g["rgd"]),
        ctypes.c_double(g["gd"]), f(g["undrift_a"]), f(g["undrift_b"]),
        ptr(Ma), ptr(Mb), ptr(Aa), ptr(Ab), ptr(dirs),
        int(with_dirs), dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(lib, rc, "dp_ad launch")
    count("launches.dp_ad")
    return Ma, Mb, Aa, Ab, dirs


def cluster(W: int, A: int = 4, with_dirs: bool = True, device="cuda"):
    """``(blocks, lanes_per_thread, clusters)`` of a launch of ``W``
    lanes on a CUDA ``device``: the blocks of a plane row (1 at W <= 4096,
    lanes a thread then reported 0) and how many such clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``; 0: none)."""
    from .. import _build

    device = resolve_device(device)
    lib = _build.load("dp_ad", _declare)
    blocks, lpt = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.bst_dp_ad_cluster(W, A, int(with_dirs), device.index or 0,
                               ctypes.byref(blocks), ctypes.byref(lpt))
    _build.check(lib, -rc if rc < 0 else 0, "dp_ad cluster query")
    return blocks.value, lpt.value, rc


def _declare(lib):
    lib.bst_dp_ad_cluster.restype = ctypes.c_int
    lib.bst_dp_ad_cluster.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.bst_dp_ad.restype = ctypes.c_int
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bst_dp_ad.argtypes = [
        v, v, v, v, v, v, v,            # s, t, s_lens, t_lens, dminq, lo, hi
        v, i, f,                        # table, A, pad_sub
        i, i, i, i, i, i, i,            # B2, LS, LT, W, Apad, R, flags
        f, f, f, ctypes.c_double, f, f,  # go, two_gd, rgd, gd, undrift a/b
        v, v, v, v, v,                  # Ma, Mb, Aa, Ab, dirs
        i, i, v,                        # with_dirs, device, stream
    ]


def _finish(g, Ma, Mb, Aa, Ab, dirs, flags: ModeFlags, with_dirs: bool):
    """Scores and end cells from the per-lane maxima (the reference's
    post-kernel recovery, shared by both engines)."""
    dev = Ma.device
    B, B2, W = g["B"], g["B2"], g["W"]
    even_k = (torch.arange(W, device=dev) % 2) == 0
    # pair p's slots have (a + k) ≡ p: the even-step maxima hold pair 0
    # on even lanes and pair 1 on odd lanes, the odd-step maxima the
    # reverse
    v0 = torch.where(even_k, Ma, Mb)
    v1 = torch.where(even_k, Mb, Ma)
    # dead lanes accumulate below NEG: report dead results as NEG
    score = torch.stack([v0.max(dim=1).values, v1.max(dim=1).values],
                        dim=1).reshape(2 * B2)[:B].clamp(min=float(_NEGF))
    if not with_dirs:
        sent = torch.full((B,), -1, dtype=torch.int32, device=dev)
        return DPResult(score=score, end_i=sent, end_j=sent,
                        dirs=torch.empty((0,), dtype=torch.uint8,
                                         device=dev))
    if flags.local_end or flags.free_end_edges:
        dq = g["dminq"].reshape(B2, 2)
        ends = []
        for p, v, Ast in ((0, v0, torch.where(even_k, Aa, Ab)),
                          (1, v1, torch.where(even_k, Ab, Aa))):
            k_star = torch.argmax(v, dim=1)
            a_star = Ast.gather(1, k_star[:, None])[:, 0]
            d_star = dq[:, p] + k_star.to(torch.int32)
            ends.append((torch.div(a_star + d_star, 2, rounding_mode="floor"),
                         torch.div(a_star - d_star, 2,
                                   rounding_mode="floor")))
        end_i = torch.stack([ends[0][0], ends[1][0]], 1).reshape(-1)[:B]
        end_j = torch.stack([ends[0][1], ends[1][1]], 1).reshape(-1)[:B]
        end_i, end_j = end_i.to(torch.int32), end_j.to(torch.int32)
    else:
        end_i, end_j = g["s_lens_in"], g["t_lens_in"]
    return DPResult(score=score, end_i=end_i, end_j=end_j, dirs=dirs)


def _run(engine, s_codes, t_codes, s_lens, t_lens, dmin, W, subst, go, ge,
         flags, w_eff, with_dirs, r_chunk, device, return_codes=False):
    with Phase("dp_ad.inputs"):
        g = _geometry(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, W=W,
                      subst=subst, go=go, ge=ge, r_chunk=r_chunk,
                      device=device)
    if g["B"] == 0:
        raise ValueError("empty batch")
    res = _finish(g, *engine(g, flags, with_dirs), flags, with_dirs)
    if return_codes:
        return res, tuple(g[k] for k in ("s_codes", "t_codes", "s_lens_in",
                                         "t_lens_in"))
    return res


def banded_dp_ad(s_codes, t_codes, s_lens, t_lens, dmin, *, W: int, subst,
                 go: float, ge: float, flags: ModeFlags, w_eff=None,
                 with_dirs: bool = False, r_chunk: int = 128,
                 device="cuda", return_codes: bool = False) -> DPResult:
    """Antidiagonal dual-pair banded DP over a batch of pairs.

    Inputs (numpy arrays, or tensors already on ``device``):
    ``s_codes`` int8 [B, LS], ``t_codes`` int8 [B, LT], ``s_lens`` /
    ``t_lens`` / ``dmin`` / ``w_eff`` int32 [B].  The band of pair b is
    the TOP ``min(w_eff, W - 1)`` diagonals of ``[dmin, dmin + W)``
    (one lane of slack absorbs the parity adjustment); ``W`` is even, a
    multiple of 4 above 2048 and of 128 above 4096 (the kernel takes up
    to :data:`MAX_W`, the twin any).  ``subst`` [A, A], ``A`` at most
    127; ``go, ge <= 0``.

    Returns :class:`DPResult`: ``score`` f32 [B]; without ``with_dirs``
    ``end_i`` / ``end_j`` are -1 sentinels and ``dirs`` is empty; with
    it, the end cells and the dirs plane ``[Apad // 2, B2, W]`` uint8
    (layout: module docstring).  ``return_codes`` returns ``(result,
    codes)`` instead, where ``codes`` are the inputs as the kernel read
    them on ``device``: ``(s_codes [Bp, LS], t_codes [Bp, LT], s_lens
    [B], t_lens [B])`` (``Bp``: B rounded up to whole plane rows), for
    later work on the card that reads them without another copy.

    On a CUDA ``device`` this launches the kernel of ``csrc/dp_ad.cu``
    (built on first use) and raises if it cannot; on the CPU it runs
    :func:`banded_dp_ad_reference`.
    """
    device = resolve_device(device)
    engine = _sweep_cuda if device.type == "cuda" else _sweep_plain
    return _run(engine, s_codes, t_codes, s_lens, t_lens, dmin, W, subst,
                go, ge, flags, w_eff, with_dirs, r_chunk, device,
                return_codes)


def banded_dp_ad_reference(s_codes, t_codes, s_lens, t_lens, dmin, *,
                           W: int, subst, go: float, ge: float,
                           flags: ModeFlags, w_eff=None,
                           with_dirs: bool = False, r_chunk: int = 128,
                           device="cuda") -> DPResult:
    """The plain PyTorch twin of :func:`banded_dp_ad` on any device
    (vectorised over pairs and lanes, a Python loop over antidiagonals):
    same arguments, same outputs, bit for bit."""
    return _run(_sweep_plain, s_codes, t_codes, s_lens, t_lens, dmin, W,
                subst, go, ge, flags, w_eff, with_dirs, r_chunk,
                resolve_device(device))
