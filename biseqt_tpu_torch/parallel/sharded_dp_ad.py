"""Band-sharded antidiagonal DP: halo exchange every C steps, and its
checkpointed traceback.

The port of :mod:`biseqt_tpu.parallel.sharded_dp_ad`.  The engine
iterates antidiagonals ``a = i + j`` as the single-card kernel
(:mod:`..ops.dp_ad`) does, so every DP predecessor lives in an earlier
wavefront and the only coupling between band ranks is their edge
lanes, which are *chunked*: each rank carries a halo of C lanes on each
side of its Wl owned lanes, runs C steps with no communication (a
halo's staleness creeps inward one lane a step and never reaches the
interior), then trades C lanes of the stacked (H2, H1, E, F) with each
neighbour (``batch_isend_irecv`` on the band group; a mesh edge's halo
is ``NEG``).

**Dual-pair parity packing**: a cell (i, j) lives on lane d = i - j only
when (a + d) is even, so plane row b2 hosts pairs (2 b2, 2 b2 + 1) on
the two parity sublattices: pair p's band start is adjusted up to
dmin' ≡ p (mod 2) (:func:`..ops.dp_ad.parity_adjusted_dmin`), and
interleaved letter streams feed both pairs from one sliding window.
``w_eff <= W - 1``: one lane of slack absorbs the adjustment.

**Traceback** (:func:`band_sharded_ad_traceback`): the forward pass
checkpoints each rank's interior (H2, H1, E, F) every ``ckpt_chunks``
halo chunks, then re-solves one checkpoint window at a time (newest
first) through the same step function, emitting direction bytes only
for that window, which every rank gathers and walks with the resumable
C++ window walker (:func:`..native.traceback_ad_window_batch`).
Direction memory is O(B2 · C · m · W) per window instead of
O((LS+LT) · W) for the whole plane.

Plain PyTorch on the mesh's device: the JAX package computes this with
``lax`` steps under ``shard_map`` and reaches no Pallas kernel.  Every
float operation is the JAX package's, in its order, so scores and
direction bytes equal its own exactly.  In a world of one no collective
is called, and on a card the steps are replayed from CUDA graphs
(:func:`..ops.steps.run_steps`, one graph kept across the windows of a
sweep).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..ops.banded_dp import (NEG, ModeFlags, _check_gap_scores, _host,
                             on_device, shift_lanes)
from ..ops.dp_ad import PAD_S, PAD_T, parity_adjusted_dmin
from ..ops.steps import put, run_steps
from ..profiling import Phase
from .mesh import BAND_AXIS
from .sharded_dp import _band_exchange, _band_gather, _band_max, _band_mesh

__all__ = ["banded_dp_band_sharded_ad", "band_sharded_ad_traceback"]


def _shift_stream(codes, shifts, valid_len, out_len: int, pad: int):
    """``out[b, x] = codes[b, x + shifts[b]]`` where ``0 <= x + shift <
    valid_len``, else ``pad``: a batched variable shift as one masked
    gather.  The source index wraps modulo ``out_len`` as the JAX
    package's roll chain does, so the two agree everywhere (where the
    mask passes they read the same letter as long as the ring covers
    ``valid_len``, the ring rule of :func:`_prep_streams`)."""
    B, L = codes.shape
    if out_len > L:
        codes = torch.cat([codes, codes.new_full((B, out_len - L), pad)], 1)
    else:
        codes = codes[:, :out_len]
    xx = torch.arange(out_len, dtype=torch.int64, device=codes.device)
    src = xx[None, :] + shifts.to(torch.int64)[:, None]
    out = codes.gather(1, torch.remainder(src, out_len))
    ok = (src >= 0) & (src < valid_len.to(torch.int64)[:, None])
    return torch.where(ok, out, torch.full_like(out, pad))


def _pair_geometry(B: int, LS: int, LT: int, C: int, ckpt_every: int = 0):
    """Static ints shared by the streams and the traceback:
    (Bp, B2, Apad).  Apad = steps 0..LS+LT inclusive rounded up to whole
    halo chunks (and whole checkpoint windows when asked)."""
    Bp = ((B + 1) // 2) * 2
    gran = C * max(int(ckpt_every), 1)
    Aend = LS + LT + 1
    return Bp, Bp // 2, ((Aend + gran - 1) // gran) * gran


def _prep_streams(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, *,
                  W: int, C: int, ckpt_every: int = 0, device):
    """Dual-pair packing and the interleaved letter streams (the JAX
    package's ``_prep_streams``, array for array).  Returns a dict of
    tensors on ``device`` plus the static geometry (B, Bp, B2, Apad)."""
    s_codes = on_device(s_codes, torch.int8, device)
    t_codes = on_device(t_codes, torch.int8, device)
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    i32 = lambda x: on_device(x, torch.int32, device).reshape(B)
    s_lens, t_lens, dmin = i32(s_lens), i32(t_lens), i32(dmin)
    if w_eff is None:
        w_eff = torch.full((B,), W - 1, dtype=torch.int32, device=device)
    # <= W - 1 is load-bearing: the parity adjustment drops each pair's
    # bottom lane (dminq = dmin + up), as in the single-card kernel
    w_eff = i32(w_eff).clamp(max=W - 1)

    # pair up: plane b2 holds pairs (2 b2, 2 b2 + 1); an odd B pads one
    # inert length-1 pair
    Bp, B2, Apad = _pair_geometry(B, LS, LT, C, ckpt_every)
    pad = Bp - B

    def padb(x, fill):
        return torch.cat([x, x.new_full((pad,), fill)]) if pad else x

    if pad:
        s_codes = torch.cat([s_codes, s_codes.new_full((pad, LS), PAD_S)])
        t_codes = torch.cat([t_codes, t_codes.new_full((pad, LT), PAD_T)])
    s_lens_p, t_lens_p = padb(s_lens, 1), padb(t_lens, 1)
    dmin_p, weff_p = padb(dmin, 0), padb(w_eff, 1)

    pair_id = torch.arange(Bp, dtype=torch.int32, device=device) % 2
    dminq = parity_adjusted_dmin(dmin_p, pair_id)   # dmin' ≡ pair (mod 2)
    up = dminq - dmin_p                             # in {0, 1}

    # interleaved letter streams.  Slot (global lane kg, step a) of pair
    # p is cell (i, j) = ((a + d)/2, (a - d)/2), d = dmin'_p + kg; with
    # z = a + kg (z ≡ p mod 2) it reads SI[z] = S_{z%2}[(z + dmin')/2 -
    # 1] and TI[u] = T_{u%2}[(u - dmin')/2 - 1], u = a - kg.  u is
    # negative for valid cells when dmin' < 0, so the t stream is stored
    # at x = u + W; s_exp prepends C pads so a rank's slice offset
    # a + g0 stays nonnegative; t is served flipped (u falls as the lane
    # grows).  Ring rule: each half stream's ring covers its largest
    # valid source index (>= LS / LT), or a wrapped letter would pass
    # the validity mask.
    Mlen = max((Apad + W + 2 * C) // 2 + 2, LS, LT + W // 2)
    Mlen = ((Mlen + 127) // 128) * 128
    s_shift = torch.where(pair_id == 0, dminq // 2 - 1,
                          (dminq + 1) // 2 - 1)
    t_shift = torch.where(pair_id == 0, -(dminq // 2) - 1,
                          (1 - dminq) // 2 - 1) - (W // 2)
    s_half = _shift_stream(s_codes, s_shift, s_lens_p, Mlen, PAD_S)
    t_half = _shift_stream(t_codes, t_shift, t_lens_p, Mlen, PAD_T)
    si = torch.stack([s_half[0::2], s_half[1::2]], dim=2).reshape(B2,
                                                                  2 * Mlen)
    ti = torch.stack([t_half[0::2], t_half[1::2]], dim=2).reshape(B2,
                                                                  2 * Mlen)
    s_exp = torch.cat([si.new_full((B2, C), PAD_S), si], 1)
    # t_flip[y] = ti[Apad + C + W - y] = TI[Apad + C - y]; tail pads cover
    # y up to Apad + W + 2C - 1 (the top halo lanes of the last rank)
    t_flip = torch.cat([torch.flip(ti[:, :Apad + C + W + 1], [1]),
                        ti.new_full((B2, C), PAD_T)], 1)

    col = lambda x: x.reshape(B2, 2)
    return dict(s_exp=s_exp, t_flip=t_flip, dminq=dminq, dminq2=col(dminq),
                sl2=col(s_lens_p), tl2=col(t_lens_p),
                lo2=col(W - up - weff_p),     # live lanes [lo, hi) per pair
                hi2=col(W - up), B=B, Bp=Bp, B2=B2, Apad=Apad)


class _Geom:
    """A rank's lane geometry, masks and constants, shared by the
    forward pass and the window re-solve: everything that depends on
    the pair scalars and the mesh position, not on the DP state."""

    def __init__(self, p, subst, *, W: int, C: int, A: int, go: float,
                 ge: float, flags: ModeFlags, mesh):
        dev = mesh.device
        self.mesh, self.flags = mesh, flags
        self.nb = nb = mesh.shape[BAND_AXIS]
        self.Wl = Wl = W // nb
        self.C, self.W, self.Apad = C, W, p["Apad"]
        self.B2 = B2 = p["B2"]
        self.Wle = Wle = Wl + 2 * C
        self.go, self.ge = float(go), float(ge)
        g0 = mesh.band_rank * Wl               # first owned global lane
        lane = torch.arange(Wle, dtype=torch.int32, device=dev)[None, :]
        self.kg = kg = lane + (g0 - C)         # global lane ids incl. halo
        self.interior = (lane >= C) & (lane < C + Wl)
        self.kg_even = kg_even = (kg % 2) == 0

        dq, sl, tl = p["dminq2"], p["sl2"], p["tl2"]
        lo, hi = p["lo2"], p["hi2"]
        self.d0, self.d1 = d0, d1 = dq[:, 0:1], dq[:, 1:2]
        self.sl0, self.sl1 = sl[:, 0:1], sl[:, 1:2]
        self.tl0, self.tl1 = tl[:, 0:1], tl[:, 1:2]
        self.sltl0 = self.sl0 + self.tl0
        self.sltl1 = self.sl1 + self.tl1
        self.kc0 = self.sl0 - self.tl0 - d0     # global corner lane (sl, tl)
        self.kc1 = self.sl1 - self.tl1 - d1

        # pair p owns slots with (a + kg) ≡ p (mod 2): at even a even
        # lanes are pair 0's, at odd a they swap.  Live lanes are each
        # pair's top w_eff diagonals [lo, hi).  Additive float masks
        # (0 live / NEG dead), one add a step.
        okf0 = torch.where((kg >= lo[:, 0:1]) & (kg < hi[:, 0:1]), 0.0, NEG)
        okf1 = torch.where((kg >= lo[:, 1:2]) & (kg < hi[:, 1:2]), 0.0, NEG)
        self.okf = (torch.where(kg_even, okf0, okf1),      # a even
                    torch.where(kg_even, okf1, okf0))      # a odd

        # corner-seed boundary injection: the substitution at (0, 0)
        # reads pads -> the poison -1.0, so seeding H2 = +1.0 on the
        # corner's lane makes the a = 0 step give H(0, 0) = 0, and the
        # E / F chains grow the gap rays from it (one lane a pair: -d0
        # is even, -d1 odd)
        if not (flags.local_start or flags.free_start_edges):
            self.H2_0 = torch.where((kg == -d0) | (kg == -d1), 1.0, NEG)
        else:
            self.H2_0 = torch.full((B2, Wle), NEG, device=dev)

        # the substitution table with a pad row and column: the JAX
        # package's select chain over an A x A table (codes clipped into
        # it) and its -1.0 poison for a pad on either side, as one gather
        # from precomputed index streams
        table = torch.full((A + 1, A + 1), -1.0, device=dev)
        table[:A, :A] = torch.as_tensor(
            np.asarray(subst, np.float32)[:A, :A], device=dev)
        self.table = table.reshape(-1)
        code = lambda x: torch.where(x < 0, A, x.to(torch.int64).clamp(
            0, A - 1))
        self.s_idx = code(p["s_exp"]) * (A + 1)
        self.t_idx = code(p["t_flip"])
        # a slot (lane, a) reads s_exp[a + g0 + lane] and
        # t_flip[Apad + g0 - a + lane]
        self.s_base, self.t_base = g0, self.Apad + g0
        lanes = torch.arange(Wle, dtype=torch.int64, device=dev)
        self.s_lanes, self.t_lanes = lanes + g0, lanes + self.t_base

    def sub_at(self, at):
        """The substitution scores [B2, Wle] of step ``at``."""
        if isinstance(at, int):
            s0, t0 = self.s_base + at, self.t_base - at
            s = self.s_idx[:, s0:s0 + self.Wle]
            t = self.t_idx[:, t0:t0 + self.Wle]
        else:
            s = self.s_idx.index_select(1, self.s_lanes + at)
            t = self.t_idx.index_select(1, self.t_lanes - at)
        return self.table[s + t]

    def refresh_halos(self, state):
        """The neighbours' interior edge lanes of the stacked (H2, H1, E,
        F) become this rank's halos (``NEG`` at a mesh edge); the rest of
        ``state`` passes through."""
        if self.nb == 1:
            return state
        C, Wl = self.C, self.Wl
        X = torch.stack(state[:4])
        got_l, got_r = _band_exchange(self.mesh, to_left=X[:, :, C:2 * C],
                                     to_right=X[:, :, Wl:C + Wl])
        X = torch.cat([got_l, X[:, :, C:C + Wl], got_r], dim=2)
        return tuple(X.unbind(0)) + tuple(state[4:])

    def sweep(self, step, state, a0: int, n_chunks: int, graphs=None):
        """``n_chunks`` halo chunks of ``step`` from antidiagonal ``a0``,
        each entered by a halo refresh.  In a world of one there is no
        refresh, and the whole run is one :func:`run_steps`."""
        C = self.C
        if self.nb == 1:
            return run_steps(step, state, range(a0, a0 + n_chunks * C),
                             graphs)
        for c in range(n_chunks):
            state = self.refresh_halos(state)
            for a in range(a0 + c * C, a0 + (c + 1) * C):
                state = step(a, a, state)
        return state


def _ad_step(g: _Geom, H2, H1, E, F, a: int, at, want_dirs: bool = False):
    """One antidiagonal step of the sharded recurrence, shared by the
    forward pass and the window re-solve (they must evolve bit for bit
    alike for the checkpoints to replay).  ``a`` gives the step's parity
    only; ``at`` is the step (an int, or a one-element device tensor in
    a CUDA graph).

    Returns ``(H1, H_masked, E, F, byte)``: the next carry and, with
    ``want_dirs``, the direction byte of every slot (bits 0-1 the H
    source 0 stop / 1 diag / 2 E / 3 F, bit 2 E-extend, bit 3 F-extend;
    the tests use the pre-mask H, so the additive lane masks cannot
    break them)."""
    flags = g.flags
    sub = g.sub_at(at)
    HpGo = H1 + g.go
    byte = None
    if want_dirs:
        # gap-extension flags BEFORE the chain update (a cell reads its
        # source's choice), shifted as the chain is; ties prefer
        # extension.  Pre-weighted 4.0 / 8.0: the byte is two adds.
        e4 = shift_lanes(torch.where(E >= HpGo, 4.0, 0.0), -1, 0.0)
        f8 = shift_lanes(torch.where(F >= HpGo, 8.0, 0.0), 1, 0.0)
    E = shift_lanes(torch.maximum(HpGo, E), -1, NEG) + g.ge
    F = shift_lanes(torch.maximum(HpGo, F), 1, NEG) + g.ge
    diag_cand = H2 + sub
    H_new = torch.maximum(torch.maximum(diag_cand, E), F)
    if flags.local_start:
        H_new = torch.clamp_min(H_new, 0.0)
    if flags.free_start_edges:
        # the boundary rays i == 0 / j == 0 of each pair are free starts
        kg = g.kg
        ray = ((kg == (-g.d0 - at)) | (kg == (at - g.d0))
               | (kg == (-g.d1 - at)) | (kg == (at - g.d1)))
        H_new = torch.maximum(H_new, torch.where(ray, 0.0, NEG))
    if want_dirs:
        d = torch.where(H_new == diag_cand, 1.0,
                        torch.where(H_new == E, 2.0, 3.0))
        if flags.local_start:
            # a fresh local start: value 0 and the diag source lost
            d = torch.where((H_new == 0.0) & (diag_cand < 0.0), 0.0, d)
        byte = (d + e4 + f8).to(torch.int32).to(torch.uint8)
    H_masked = H_new + g.okf[a % 2]
    return H1, H_masked, E, F, byte


def _tracked(g: _Geom, H_new, at):
    """The values the end trackers take at step ``at``: every cell
    (local end), the i == slen and j == tlen rays (overlap ends) or the
    corner (global)."""
    flags, kg = g.flags, g.kg
    if flags.local_end:
        return H_new
    if flags.free_end_edges:
        # slots are pair-disjoint by parity, so one OR is safe
        cond = (((kg == (2 * g.sl0 - g.d0 - at)) & (at >= g.sl0)
                 & (at <= g.sltl0))
                | ((kg == (at - g.d0 - 2 * g.tl0)) & (at >= g.tl0)
                   & (at <= g.sltl0))
                | ((kg == (2 * g.sl1 - g.d1 - at)) & (at >= g.sl1)
                   & (at <= g.sltl1))
                | ((kg == (at - g.d1 - 2 * g.tl1)) & (at >= g.tl1)
                   & (at <= g.sltl1)))
    else:
        cond = (((at == g.sltl0) & (kg == g.kc0))
                | ((at == g.sltl1) & (kg == g.kc1)))
    return torch.where(cond, H_new, NEG)


def _forward(g: _Geom, ckpt_every: int = 0):
    """The forward pass on this rank.  Returns the [B2, 2] per-pair
    scores (combined over the band) and, with ``ckpt_every = m``, this
    rank's interior trackers ``(Me, Mo, Ae, Ao)`` [B2, Wl] and
    checkpoints [n_windows, 4, B2, Wl]: the interior (H2, H1, E, F)
    entering each window of m halo chunks."""
    C, Wl, B2, Wle = g.C, g.Wl, g.B2, g.Wle
    dev = g.kg.device
    track = bool(ckpt_every)

    def step(a, at, state):
        if track:
            H2, H1, E, F, Me, Mo, Ae, Ao = state
        else:
            H2, H1, E, F, Me, Mo = state
        H2n, H_new, E, F, _ = _ad_step(g, H2, H1, E, F, a, at)
        tracked = _tracked(g, H_new, at)
        # per-step-parity accumulators: pair p's values sit on lanes
        # kg ≡ p at even a and kg ≢ p at odd a (split after the loop);
        # Ae / Ao the step of each lane's strict maximum, for the
        # traceback's end cells
        if a % 2 == 0:
            if track:
                Ae = torch.where(tracked > Me, at, Ae).to(torch.int32)
            Me = torch.maximum(Me, tracked)
        else:
            if track:
                Ao = torch.where(tracked > Mo, at, Ao).to(torch.int32)
            Mo = torch.maximum(Mo, tracked)
        if track:
            return H2n, H_new, E, F, Me, Mo, Ae, Ao
        return H2n, H_new, E, F, Me, Mo

    neg = torch.full((B2, Wle), NEG, device=dev)
    state = (g.H2_0, neg, neg, neg, neg, neg)
    n_chunks = g.Apad // C
    if not track:
        state = g.sweep(step, state, 0, n_chunks)
    else:
        minus1 = torch.full((B2, Wle), -1, dtype=torch.int32, device=dev)
        state = state + (minus1, minus1)
        m = int(ckpt_every)
        n_outer = n_chunks // m
        cks = torch.empty((n_outer, 4, B2, Wl), device=dev)
        graphs = {}
        for co in range(n_outer):
            # the checkpoint is the state ENTERING the window: its
            # interior lanes are the unsharded state at a step boundary
            # (the halos are the neighbours' business)
            cks[co] = torch.stack(state[:4])[:, :, C:C + Wl]
            state = g.sweep(step, state, co * m * C, m, graphs)

    # per-pair separation by lane parity, interior lanes only
    Me, Mo = state[4], state[5]
    v0 = torch.where(g.kg_even, Me, Mo)
    v1 = torch.where(g.kg_even, Mo, Me)
    s0 = torch.where(g.interior, v0, NEG).max(dim=1).values
    s1 = torch.where(g.interior, v1, NEG).max(dim=1).values
    out = _band_max(torch.stack([s0, s1], dim=1), g.mesh)      # [B2, 2]
    if not track:
        return out
    iv = (slice(None), slice(C, C + Wl))
    return (out,) + tuple(x[iv] for x in state[4:8]) + (cks,)


def _resolve_window(g: _Geom, init4, a0: int, m: int, graphs=None,
                    dirs=None):
    """Re-solve ONE checkpoint window (steps [a0, a0 + m*C)) on this
    rank from its entering interior state ``init4`` [4, B2, Wl],
    through the forward pass's step function; halos start at ``NEG``
    and are refreshed at each chunk head as in the forward pass.
    Returns this rank's direction bytes [m*C, B2, Wl] uint8 (written
    into ``dirs`` when given: the buffer a kept graph writes)."""
    C, Wl, B2 = g.C, g.Wl, g.B2
    mC = m * C
    if dirs is None:
        dirs = torch.empty((mC, B2, Wl), dtype=torch.uint8,
                           device=init4.device)
    halo = torch.full((4, B2, C), NEG, device=init4.device)
    X = torch.cat([halo, init4.to(torch.float32), halo], dim=2)

    def step(a, at, state):
        H2, H1, E, F = state
        H2n, H_new, E, F, byte = _ad_step(g, H2, H1, E, F, a, at,
                                          want_dirs=True)
        put(dirs, at % mC, byte[:, C:C + Wl])
        return H2n, H_new, E, F

    g.sweep(step, tuple(X.unbind(0)), a0, m, graphs)
    return dirs


def _engine_args(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, *, W, go,
                 ge, subst, flags, mesh, device, halo, A, ckpt_every):
    """The rank's streams and geometry, after the engines' checks."""
    _check_gap_scores(go, ge)
    mesh = _band_mesh(mesh, device, W)
    nb = mesh.shape[BAND_AXIS]
    if halo < 1 or ckpt_every < 0:
        raise ValueError("halo must be positive and ckpt_chunks >= 0")
    C = int(min(halo, W // nb))
    p = _prep_streams(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, W=W,
                      C=C, ckpt_every=ckpt_every, device=mesh.device)
    g = _Geom(p, subst, W=W, C=C, A=A, go=go, ge=ge, flags=flags, mesh=mesh)
    return p, g


def _run_band_sharded_ad(s_codes, t_codes, s_lens, t_lens, dmin, *,
                         W: int, subst, go: float, ge: float,
                         flags: ModeFlags, mesh=None, w_eff=None,
                         halo: int = 64, A: int = 4, ckpt_every: int = 0,
                         device="cuda"):
    """The forward pass: scores [B]; with ``ckpt_every`` also the
    band-gathered trackers ``(Me, Mo, Ae, Ao)`` [B2, W] and this rank's
    checkpoints [n_windows, 4, B2, Wl] (a world of one: Wl = W, the JAX
    package's ``cks`` exactly)."""
    p, g = _engine_args(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, W=W,
                        go=go, ge=ge, subst=subst, flags=flags, mesh=mesh,
                        device=device, halo=halo, A=A, ckpt_every=ckpt_every)
    out = _forward(g, ckpt_every)
    if not ckpt_every:
        return out.reshape(p["Bp"])[:p["B"]]
    scores, trackers, cks = out[0], out[1:5], out[5]
    # every rank's interior [B2, Wl] trackers side by side: [B2, W]
    whole = [_band_gather(x, g.mesh).permute(1, 0, 2).reshape(g.B2, W)
             for x in trackers]
    return (scores.reshape(p["Bp"])[:p["B"]], *whole, cks)


def banded_dp_band_sharded_ad(s_codes, t_codes, s_lens, t_lens, dmin, *,
                              W: int, subst, go: float, ge: float,
                              flags: ModeFlags, mesh=None, w_eff=None,
                              halo: int = 64, A: int = 4, device="cuda"):
    """Banded DP, band axis sharded, antidiagonal iteration (score mode).

    Same contract as :func:`biseqt_tpu_torch.ops.banded_dp.banded_dp`
    (score only); returns the scores [B] on ``device``, the same on
    every rank.  ``w_eff <= W - 1`` (larger values are clamped: the
    dual-pair packing's slack lane).  ``W`` must divide by the band-axis
    size of ``mesh`` (a world of one on ``device`` by default).  Inputs
    are REPLICATED over the data axis.  ``halo`` = C, the steps between
    neighbour exchanges (2 sends of [4, B2, C] floats per C steps);
    ``A``: the alphabet size (codes are clipped into the ``A x A``
    table).
    """
    return _run_band_sharded_ad(
        s_codes, t_codes, s_lens, t_lens, dmin, W=W, subst=subst, go=go,
        ge=ge, flags=flags, mesh=mesh, w_eff=w_eff, halo=halo, A=A,
        device=device)


def band_sharded_ad_traceback(s_codes, t_codes, s_lens, t_lens, dmin, *,
                              W: int, subst, go: float, ge: float,
                              flags: ModeFlags, mesh=None, w_eff=None,
                              halo: int = 64, A: int = 4,
                              ckpt_chunks: int = 8, device="cuda"):
    """Transcripts through the band-sharded antidiagonal engine: a
    checkpoint and re-solve instead of an O((LS+LT)·W) direction plane.

    Three phases:
      1. the forward pass, checkpointing each rank's interior (H2, H1,
         E, F) every ``ckpt_chunks`` halo chunks, plus per-lane end
         trackers;
      2. per window, newest first: each rank re-solves its lanes from
         the window's checkpoint, and the ranks' direction bytes are
         gathered into [B2, m·C, W] (the only plane held);
      3. every rank walks each pair's path backward through the window
         (:func:`..native.traceback_ad_window_batch`), pausing at its
         lower edge; segments concatenate across windows.

    Returns ``(scores float32 [B] numpy, [(transcript, start_i,
    start_j)] per pair)`` on every rank; an unreachable pair (score
    below -1e29) gets ``("", -1, -1)``.
    """
    m = int(ckpt_chunks)
    if m < 1:
        raise ValueError("ckpt_chunks must be at least 1")
    p, g = _engine_args(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, W=W,
                        go=go, ge=ge, subst=subst, flags=flags, mesh=mesh,
                        device=device, halo=halo, A=A, ckpt_every=m)
    with Phase("sharded.forward") as ph:
        out, Me, Mo, Ae, Ao, cks = ph.result = _forward(g, m)
    B = p["B"]
    scores_np = _host(out.reshape(p["Bp"])[:B])
    Me, Mo, Ae, Ao = (
        _host(_band_gather(x, g.mesh).permute(1, 0, 2).reshape(g.B2, W))
        for x in (Me, Mo, Ae, Ao))
    C = g.C
    n_outer = g.Apad // (C * m)
    dminq = _host(p["dminq"])[:B]
    sl_np, tl_np = (_host(p[k]).reshape(-1)[:B] for k in ("sl2", "tl2"))

    # end-cell recovery, as the single-card kernel's: pair p's per-lane
    # maxima live on even lanes of the even-step accumulator and odd
    # lanes of the odd-step one (slot parity (a + kg) ≡ p); the
    # step-of-max arrays split the same way
    if flags.local_end or flags.free_end_edges:
        lane_even = (np.arange(W, dtype=np.int32) % 2) == 0
        v = [np.where(lane_even, Me, Mo), np.where(lane_even, Mo, Me)]
        astep = [np.where(lane_even, Ae, Ao), np.where(lane_even, Ao, Ae)]
        end_i = np.zeros((B,), np.int32)
        end_j = np.zeros((B,), np.int32)
        for b in range(B):
            b2, q = divmod(b, 2)
            k = int(np.argmax(v[q][b2]))
            a = int(astep[q][b2][k])
            d = int(dminq[b]) + k
            end_i[b] = (a + d) // 2
            end_j[b] = (a - d) // 2
    else:
        end_i = sl_np.copy()
        end_j = tl_np.copy()

    io_i = np.ascontiguousarray(end_i, np.int32)
    io_j = np.ascontiguousarray(end_j, np.int32)
    io_state = np.zeros((B,), np.int32)
    io_done = np.zeros((B,), np.int32)
    # an unreachable pair (e.g. its global corner outside the live band)
    # has no transcript: it is not walked
    unreachable = scores_np < -1e29
    io_done[unreachable] = 1
    # a local alignment of score 0 may end on a zero cell off the matrix
    # (i or j negative: the local start floors every live slot at 0);
    # the walk would stop there at once, with an empty transcript and
    # that cell as its start, so it is not started there (its letters
    # lie outside the pair's rows)
    io_done[(io_i < 0) | (io_j < 0) | (io_i > sl_np) | (io_j > tl_np)] = 1
    s_np = np.ascontiguousarray(_host(s_codes), np.int8)
    t_np = np.ascontiguousarray(_host(t_codes), np.int8)
    ops_stride = int(s_np.shape[1] + t_np.shape[1] + 2)
    segs = [[] for _ in range(B)]
    graphs = {}
    dirs = torch.empty((m * C, g.B2, g.Wl), dtype=torch.uint8,
                       device=g.kg.device)
    for co in range(n_outer - 1, -1, -1):
        a_base = co * C * m
        live = io_done == 0
        # the walks are the same on every rank, so every rank takes the
        # same windows and the collectives stay matched
        if not live.any():
            break
        if ((io_i + io_j)[live] < a_base).all():
            continue                      # every active walk is below
        with Phase("sharded.resolve"):
            win = _resolve_window(g, cks[co], a_base, m, graphs, dirs)
            whole = _band_gather(win, g.mesh)            # [nb, mC, B2, Wl]
            dirs_np = _host(whole.permute(2, 1, 0, 3).reshape(g.B2, m * C,
                                                              W))
        with Phase("sharded.walk"):
            seg = native.traceback_ad_window_batch(
                dirs_np, a_base, dminq, s_np, t_np, io_i, io_j, io_state,
                io_done, ops_stride)
        for b in range(B):
            if seg[b]:
                segs[b].append(seg[b])
    if not io_done.all():
        raise RuntimeError("the traceback did not terminate for pairs %s"
                           % np.nonzero(io_done == 0)[0][:8].tolist())

    anchored = not (flags.local_start or flags.free_start_edges)
    tx = []
    for b in range(B):
        if unreachable[b]:
            tx.append(("", -1, -1))
            continue
        back = "".join(segs[b])           # end -> start
        i, j = int(io_i[b]), int(io_j[b])
        if anchored:
            back += "I" * j + "D" * i
            i = j = 0
        tx.append((back[::-1], i, j))
    return scores_np, tx
