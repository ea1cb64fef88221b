"""Band-axis model parallelism for the row DP (giant single pairs).

The port of :mod:`biseqt_tpu.parallel.sharded_dp`.  The band width W is
split over the mesh's ``band`` axis: rank ``r`` of a band group owns
lanes ``[r*Wl, (r+1)*Wl)``, ``Wl = W / n_band``.  The row recurrence
couples the ranks twice a row:

  * the 'up' predecessor of a rank's last lane lives on its *right*
    neighbour, and the E scan's predecessor of its first lane on its
    *left* one: one lane of H and F from the right and one of H_pre from
    the left, sent point to point (``batch_isend_irecv`` on the band
    group).  A rank at an edge of the mesh has no such neighbour: its
    halo is ``NEG`` (outside the global band), never a zero;
  * the within-row affine-gap prefix max crosses ranks: a local
    ``prefix_max``, one ``all_gather`` of the ranks' last values, and
    the exclusive max over the lower ranks (the two-level scan).

The per-rank scores are combined by an ``all_reduce(MAX)`` on the band
group.  In a world of one no collective is called, and on a card the
rows are replayed from CUDA graphs (:func:`..ops.steps.run_steps`).
Plain PyTorch on the mesh's device: the JAX package computes this with
``lax`` steps under ``shard_map`` and reaches no Pallas kernel.  The
float operations are the JAX package's, in its order, so scores equal
its scores exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.banded_dp import (NEG, ModeFlags, _check_gap_scores, _init_row,
                             _subst_lookup, on_device, prefix_max,
                             resolve_device, shift_lanes)
from ..ops.steps import run_steps
from .mesh import BAND_AXIS, make_mesh

__all__ = ["banded_dp_band_sharded"]


def _band_exchange(mesh, to_left=None, to_right=None):
    """Point-to-point halo exchange on this rank's band group.

    Sends ``to_left`` to the left neighbour and ``to_right`` to the
    right one (either may be None: nothing sent that way) and returns
    ``(from_left, from_right)``: the tensors the neighbours sent this
    way, shaped like what this rank sent the other way, or filled with
    ``NEG`` where the mesh has no neighbour.  Every rank of the group
    calls it together with the same directions."""
    nb, me = mesh.shape[BAND_AXIS], mesh.band_rank
    got = {"left": None, "right": None}
    ops = []
    # a tensor sent right arrives from the left, and the other way
    for side, send, peer, recv_like in (
            ("left", to_left, me - 1, to_right),
            ("right", to_right, me + 1, to_left)):
        if recv_like is not None:
            buf = torch.full_like(recv_like, NEG)
            got[side] = buf
            if 0 <= peer < nb:
                ops.append(dist.P2POp(dist.irecv, buf,
                                      mesh.band_peer(peer),
                                      group=mesh.band_group))
        if send is not None and 0 <= peer < nb:
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  mesh.band_peer(peer),
                                  group=mesh.band_group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got["left"], got["right"]


def _band_mesh(mesh, device, W: int):
    """The mesh a band-sharded engine runs on (a world of one on
    ``device`` when ``mesh`` is None), after its checks: the mesh lives
    on ``device``, and ``W`` divides by its band-axis size."""
    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(device=device)
    if mesh.device != device:
        raise ValueError("mesh on %s passed with device=%s"
                         % (mesh.device, device))
    if W % mesh.shape[BAND_AXIS]:
        raise ValueError("W = %d must divide by the band-axis size %d"
                         % (W, mesh.shape[BAND_AXIS]))
    return mesh


def _band_gather(x, mesh):
    """``[nb] + x.shape``: every band rank's ``x``, in band order."""
    nb = mesh.shape[BAND_AXIS]
    if nb == 1:
        return x[None]
    x = x.contiguous()
    out = torch.empty((nb * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.band_group)
    return out.view((nb,) + tuple(x.shape))


def _band_max(x, mesh):
    """The elementwise max of ``x`` over the band group (the JAX
    package's ``pmax``)."""
    if mesh.shape[BAND_AXIS] == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.band_group)
    return x


def banded_dp_band_sharded(s_codes, t_codes, s_lens, t_lens, dmin, *,
                           W: int, subst, go: float, ge: float,
                           flags: ModeFlags, mesh=None, w_eff=None,
                           device="cuda"):
    """Banded DP with the band width sharded over the mesh's band axis.

    Same inputs as :func:`biseqt_tpu_torch.ops.banded_dp.banded_dp`;
    returns the per-pair score vector [B] (float32, on ``device``, the
    same on every rank).  ``mesh``: a world of one on ``device`` by
    default; ``W`` must divide by its band-axis size.  Inputs are
    REPLICATED over the data axis (this engine exists for giant single
    pairs; batch parallelism belongs to the data-axis engines).
    """
    _check_gap_scores(go, ge)
    mesh = _band_mesh(mesh, device, W)
    nb = mesh.shape[BAND_AXIS]
    Wl = W // nb
    dev = mesh.device
    s_codes = on_device(s_codes, torch.int32, dev)
    t_codes = on_device(t_codes, torch.int32, dev)
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    i32 = lambda x: on_device(x, torch.int32, dev).reshape(B)
    s_lens, t_lens, dmin = i32(s_lens), i32(t_lens), i32(dmin)
    dmax = dmin + (W - 1)
    w_eff = (torch.full((B,), W, dtype=torch.int32, device=dev)
             if w_eff is None else i32(w_eff))

    # replicated band-frame T2 (each rank's window is a slice of it)
    yy = torch.arange(LS + W, dtype=torch.int32, device=dev)[None, :]
    src = yy - dmax[:, None]
    t2 = torch.where((src >= 0) & (src < t_lens[:, None]),
                     t_codes.gather(1, src.clamp(0, LT - 1).long()), -1)
    subst = torch.as_tensor(np.asarray(subst, np.float32), device=dev)

    me = mesh.band_rank
    g0 = me * Wl
    lane = torch.arange(Wl, dtype=torch.int32, device=dev)[None, :]
    karange = lane + g0
    kf = karange.to(torch.float32)
    dmax_c, tlen_c, weff_c = dmax[:, None], t_lens[:, None], w_eff[:, None]
    is_last_lane = lane == Wl - 1
    is_first_lane = lane == 0
    t_cols = torch.arange(Wl, dtype=torch.int64, device=dev) + g0
    go, ge = float(go), float(ge)

    j0 = karange - dmax_c
    H0 = _init_row(j0, tlen_c, go, ge, flags)
    H0 = torch.where(karange < weff_c, H0, NEG)
    F0 = torch.full((B, Wl), NEG, device=dev)

    def step(a, i, state):
        """Row ``i`` (an int, or a one-element device tensor in a CUDA
        graph; ``a`` is only its parity source and unused)."""
        H_prev, F_prev, best, corner = state
        row_valid = (i <= s_lens)[:, None]
        j_idx = karange + (i - dmax_c)
        cell_valid = ((j_idx >= 0) & (j_idx <= tlen_c) & row_valid
                      & (karange < weff_c))

        # halo: the right neighbour's lane 0 of the previous row (H, F);
        # a shift fills the last lane with NEG, the halo of a mesh edge
        H_up = shift_lanes(H_prev, -1, NEG)
        F_up = shift_lanes(F_prev, -1, NEG)
        if nb > 1:
            _, from_right = _band_exchange(
                mesh, to_left=torch.stack([H_prev[:, :1], F_prev[:, :1]]))
            H_up = torch.where(is_last_lane, from_right[0], H_up)
            F_up = torch.where(is_last_lane, from_right[1], F_up)

        if isinstance(i, int):
            t_win = t2[:, g0 + i - 1:g0 + i - 1 + Wl]
            s_char = s_codes[:, min(max(i - 1, 0), LS - 1)][:, None]
        else:
            t_win = t2.index_select(1, t_cols + (i - 1))
            s_char = s_codes.index_select(1, torch.clamp(i - 1, 0, LS - 1))
        sub = _subst_lookup(subst, s_char, t_win)

        diag_cand = H_prev + sub
        F_new = torch.maximum(H_up + (go + ge), F_up + ge)
        H_pre = torch.maximum(diag_cand, F_new)
        if flags.local_start:
            H_pre = torch.clamp_min(H_pre, 0.0)
        if flags.free_start_edges:
            H_pre = torch.where(j_idx == 0, torch.clamp_min(H_pre, 0.0),
                                H_pre)
        H_pre = torch.where(cell_valid, H_pre, NEG)

        # the E scan: local prefix max + the exclusive max over the
        # lower ranks' ends
        A = shift_lanes(H_pre, 1, NEG)
        if nb > 1:
            lHpre, _ = _band_exchange(mesh, to_right=H_pre[:, -1:])
            A = torch.where(is_first_lane, lHpre, A)
        A = A + (go + ge) - ge * kf
        P_loc = prefix_max(A)
        if nb == 1:
            P_glob = P_loc
        else:
            gathered = _band_gather(P_loc[:, -1], mesh)          # [nb, B]
            lower = (torch.arange(nb, device=dev) < me)[:, None]
            excl = torch.where(lower, gathered, NEG).max(dim=0).values
            P_glob = torch.maximum(P_loc, excl[:, None])
        E = P_glob + ge * kf
        E = torch.where(cell_valid, E, NEG)

        H = torch.maximum(H_pre, E)
        H = torch.where(cell_valid, H, NEG)
        H = torch.where(row_valid, H, H_prev)
        F_new = torch.where(row_valid, F_new, F_prev)

        masked = torch.where(cell_valid, H, NEG)
        kcol = (t_lens - i + dmax)[:, None]
        at_col = torch.where(karange == kcol, masked, NEG).max(dim=1).values
        if flags.local_end or flags.free_end_edges:
            row_max = masked.max(dim=1).values
        if flags.local_end:
            best = torch.maximum(best, row_max)
        if flags.free_end_edges:
            best = torch.maximum(best, at_col)
            best = torch.maximum(best, torch.where(i == s_lens, row_max, NEG))
        corner = torch.where(i == s_lens, at_col, corner)
        return H, F_new, best, corner

    # row 0 can hold alignment ends (the j == tlen ray at i = 0, local
    # zero cells, the corner when s_lens == 0): the scan starts at i = 1,
    # so H0's cells seed best and corner; the band max combines the
    # ranks' seeds at the end
    cell_valid0 = (j0 >= 0) & (j0 <= tlen_c) & (karange < weff_c)
    H0m = torch.where(cell_valid0, H0, NEG)
    best0 = torch.full((B,), NEG, device=dev)
    if flags.local_end:
        best0 = H0m.max(dim=1).values
    ray0 = torch.where(karange == (t_lens + dmax)[:, None], H0m,
                       NEG).max(dim=1).values
    if flags.free_end_edges:
        best0 = torch.maximum(best0, ray0)
        best0 = torch.maximum(best0, torch.where(s_lens == 0,
                                                 H0m.max(dim=1).values, NEG))
    corner0 = torch.where(s_lens == 0, ray0, NEG)
    state = (H0, F0, best0, corner0)
    if nb == 1:
        state = run_steps(step, state, range(1, LS + 1))
    else:
        for i in range(1, LS + 1):
            state = step(i, i, state)
    _, _, best, corner = state
    score = best if (flags.local_end or flags.free_end_edges) else corner
    # each rank holds a partial (its lanes'); combine across the band
    return _band_max(score, mesh)
