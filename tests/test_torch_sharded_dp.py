"""The port's band-sharded DP engines and its checkpointed sweep
(biseqt_tpu_torch.parallel.sharded_dp, .sharded_dp_ad, .sweep) against
the JAX package's, on the same numpy inputs.

* Every band-sharded case of ``tests/test_parallel.py`` runs through
  both packages: the JAX package on the 8-device virtual CPU mesh (data
  2 x band 4, as its tests run), the port in a world of one on the CPU.
  The matrices are integer-valued, so every float sum is exact and the
  scores, transcripts and start cells must be EQUAL, not close.
* State carried across: the JAX forward pass's checkpoints fed to the
  port's window re-solve give the JAX re-solve's direction bytes, and
  the port's binding of the C++ window walker leaves the JAX binding's
  cursors and returns its segments.
* Worlds of 2 and 4 gloo processes on the CPU (band axis 2 and 4, and a
  2 x 2 mesh with the inputs replicated over the data axis; a small
  halo and ``ckpt_chunks`` 2, so many exchanges and window resumes):
  every rank returns the world of one's scores and transcripts exactly.
* ``checkpointed_overlap_sweep``: blocks written, one deleted and
  resumed bit for bit, equal to one ``overlap_stats_block`` and to the
  JAX package's sweep (integer fields exactly, ``p`` and ``s0`` within
  rtol 1e-5, atol 1e-6); a sweep the JAX package left half done is
  finished by the port, and a manifest that does not match raises.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from biseqt_tpu_torch import native
from biseqt_tpu_torch.ops.banded_dp import ModeFlags
from biseqt_tpu_torch.parallel import make_mesh
from biseqt_tpu_torch.parallel import sharded_dp_ad as port_ad
from biseqt_tpu_torch.parallel.sharded_dp import banded_dp_band_sharded
from biseqt_tpu_torch.parallel.sweep import checkpointed_overlap_sweep

RTOL, ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT_S = 240
UNIT = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
GO, GE = -2.0, -1.0
MODES = [dict(), dict(local_start=True, local_end=True),
         dict(free_start_edges=True, free_end_edges=True)]
CPU = dict(device="cpu")


def _jax():
    """The JAX package's engines and its (data 2, band 4) mesh."""
    from biseqt_tpu.ops.banded_dp import ModeFlags as JFlags
    from biseqt_tpu.parallel import make_mesh as jax_mesh
    from biseqt_tpu.parallel import sharded_dp, sharded_dp_ad

    return JFlags, jax_mesh(n_data=2, n_band=4), sharded_dp, sharded_dp_ad


def _j(*arrays):
    import jax.numpy as jnp

    return [None if a is None else jnp.asarray(a) for a in arrays]


def _mutated_pairs(rng, B, L, pad_s, pad_t):
    """``test_parallel.py``'s homologous pairs: ``B`` random sequences of
    ``L`` letters and their mutants, packed."""
    from biseqt_tpu.sequence import Alphabet, pack_sequences
    from biseqt_tpu.stochastics import MutationProcess, rand_seq

    A4 = Alphabet("ACGT")
    M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    ss, ts = [], []
    for _ in range(B):
        S = rand_seq(A4, L, rng=rng)
        T, _ = M.mutate(S)
        ss.append(S), ts.append(T)
    s_codes, s_lens = pack_sequences(ss, pad_to=pad_s)
    t_codes, t_lens = pack_sequences(ts, pad_to=pad_t)
    return s_codes, t_codes, s_lens, t_lens


def _edge_pairs():
    """All-mismatch edges inside the valid region (the halo-bug
    geometry of ``test_parallel.py:126``): W 64 << L 96."""
    B, L = 2, 96
    s_codes = np.zeros((B, L), np.int8)
    t_codes = np.full((B, L), 1, np.int8)
    t_codes[1, :48] = 0
    lens = np.full((B,), L, np.int32)
    return s_codes, t_codes, lens, lens.copy()


def _case(rng, name):
    """The inputs of a band-sharded case of ``test_parallel.py``:
    ``(args, kw)`` with args (s_codes, t_codes, s_lens, t_lens, dmin)."""
    if name in ("matches_unsharded", "ad_matches_unsharded"):
        args = _mutated_pairs(rng, 2, 120, 128, 160)
        dmin = [-128, -120] if name == "matches_unsharded" else [-128, -121]
        kw = dict(W=256)
        if name == "ad_matches_unsharded":
            kw.update(w_eff=np.asarray([255, 200], np.int32), halo=16)
    elif name in ("edge_lanes", "ad_edge_lanes"):
        args = _edge_pairs()
        dmin = [-32, -32]
        kw = dict(W=64)
        if name == "ad_edge_lanes":
            kw.update(w_eff=np.asarray([63, 63], np.int32), halo=8)
    elif name == "ad_dual_pair_batch":
        args = _mutated_pairs(rng, 5, 150, 160, 192)
        dmin = [-64, -63, -30, -80, -64]
        kw = dict(W=128, w_eff=np.asarray([100, 127, 64, 120, 127],
                                          np.int32), halo=16)
    elif name == "traceback":
        args = _mutated_pairs(rng, 3, 120, 128, 160)
        dmin = [-128, -121, -60]
        kw = dict(W=256, w_eff=np.asarray([255, 200, 100], np.int32),
                  halo=16, ckpt_chunks=2)
    else:
        raise KeyError(name)
    return tuple(args) + (np.asarray(dmin, np.int32),), kw


def _skewed(rng):
    """``test_parallel.py:417``'s planted 100-mer at dmin 480."""
    S = rng.integers(0, 4, 600).astype(np.int8)
    T = np.pad(S[481:581], (0, 28), constant_values=0)[None, :]
    return (S[None, :], T, np.asarray([600], np.int32),
            np.asarray([100], np.int32), np.asarray([480], np.int32))


# ---------------------------------------------------------------------------
# a world of one against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", range(3))
@pytest.mark.parametrize("case", ["matches_unsharded", "edge_lanes"])
def test_row_engine_matches_jax(rng, case, mode):
    """``test_band_sharded_dp_matches_unsharded`` and ``_edge_lanes_valid``
    (``test_parallel.py:90``, ``:126``): the row engine, every mode."""
    JFlags, jmesh, jdp, _ = _jax()
    args, kw = _case(rng, case)
    with jmesh:
        want = np.asarray(jdp.banded_dp_band_sharded(
            *_j(*args), subst=UNIT, go=GO, ge=GE, flags=JFlags(**MODES[mode]),
            mesh=jmesh, **kw))
    got = banded_dp_band_sharded(*args, subst=UNIT, go=GO, ge=GE,
                                 flags=ModeFlags(**MODES[mode]),
                                 mesh=make_mesh(**CPU), **kw, **CPU)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", [dict(free_end_edges=True), dict()])
def test_row_engine_row0_ends_match_jax(mode):
    """``test_band_sharded_row0_ends`` (``test_parallel.py:386``): a
    free-end optimum on row 0 and an empty-origin global pair."""
    JFlags, jmesh, jdp, _ = _jax()
    B, L, W = 2, 8, 64
    args = (np.full((B, L), 2, np.int8), np.zeros((B, L), np.int8),
            np.asarray([2, 0], np.int32), np.asarray([1, 1], np.int32),
            np.asarray([-32, -32], np.int32))
    subst = np.full((4, 4), -100.0, np.float32)
    w_eff = np.asarray([W - 1, W - 1], np.int32)
    with jmesh:
        want = np.asarray(jdp.banded_dp_band_sharded(
            *_j(*args), W=W, subst=subst, go=GO, ge=GE,
            flags=JFlags(**mode), mesh=jmesh, w_eff=_j(w_eff)[0]))
    got = banded_dp_band_sharded(*args, W=W, subst=subst, go=GO, ge=GE,
                                 flags=ModeFlags(**mode), w_eff=w_eff, **CPU)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", range(3))
@pytest.mark.parametrize("case", ["ad_matches_unsharded", "ad_edge_lanes",
                                  "ad_dual_pair_batch"])
def test_ad_engine_matches_jax(rng, case, mode):
    """``test_band_sharded_ad_matches_unsharded``, ``_edge_lanes_valid``
    and ``_dual_pair_batch`` (``test_parallel.py:250``, ``:292``,
    ``:463``): mixed dmin parities, an odd batch, small halos."""
    JFlags, jmesh, _, jad = _jax()
    args, kw = _case(rng, case)
    w_eff = kw.pop("w_eff")
    with jmesh:
        want = np.asarray(jad.banded_dp_band_sharded_ad(
            *_j(*args), subst=UNIT, go=GO, ge=GE, flags=JFlags(**MODES[mode]),
            mesh=jmesh, w_eff=_j(w_eff)[0], **kw))
    got = port_ad.banded_dp_band_sharded_ad(
        *args, subst=UNIT, go=GO, ge=GE, flags=ModeFlags(**MODES[mode]),
        w_eff=w_eff, **kw, **CPU)
    assert np.array_equal(got.numpy(), want)


def test_ad_engine_skewed_lengths_match_jax(rng):
    """``test_band_sharded_ad_skewed_lengths`` (``test_parallel.py:417``):
    the letter streams' ring at dmin 480, and the identity pair with the
    default w_eff."""
    JFlags, jmesh, _, jad = _jax()
    args = _skewed(rng)
    kw = dict(W=128, subst=UNIT, go=GO, ge=GE, halo=16)
    flags = dict(local_start=True, local_end=True)
    w_eff = np.asarray([127], np.int32)
    with jmesh:
        want = np.asarray(jad.banded_dp_band_sharded_ad(
            *_j(*args), flags=JFlags(**flags), mesh=jmesh,
            w_eff=_j(w_eff)[0], **kw))
    got = port_ad.banded_dp_band_sharded_ad(
        *args, flags=ModeFlags(**flags), w_eff=w_eff, **kw, **CPU).numpy()
    assert np.array_equal(got, want) and got[0] > 90

    eq = np.zeros((1, 64), np.int8)
    lens = np.asarray([64], np.int32)
    args2 = (eq, eq, lens, lens, np.asarray([-1], np.int32))
    with jmesh:
        want2 = np.asarray(jad.banded_dp_band_sharded_ad(
            *_j(*args2), flags=JFlags(), mesh=jmesh, **kw))
    got2 = port_ad.banded_dp_band_sharded_ad(*args2, flags=ModeFlags(),
                                             **kw, **CPU).numpy()
    assert np.array_equal(got2, want2) and got2[0] == 64.0


def _rescore(ops, s, t, si, sj, subst):
    score, i, j, prev = 0.0, si, sj, None
    for op in ops:
        if op in "MS":
            assert (s[i] == t[j]) == (op == "M")
            score += subst[s[i], t[j]]
            i, j = i + 1, j + 1
        elif op == "I":
            score += GE + (GO if prev != "I" else 0.0)
            j += 1
        else:
            score += GE + (GO if prev != "D" else 0.0)
            i += 1
        prev = op
    return score, i, j


@pytest.mark.parametrize("mode", range(3))
def test_traceback_matches_jax(rng, mode):
    """``test_band_sharded_ad_traceback_rescores`` (``test_parallel.py:
    529``): scores, transcripts and start cells equal the JAX package's
    exactly, and every transcript rescores to its score."""
    JFlags, jmesh, _, jad = _jax()
    args, kw = _case(rng, "traceback")
    w_eff = kw.pop("w_eff")
    flags = MODES[mode]
    with jmesh:
        want_s, want_tx = jad.band_sharded_ad_traceback(
            *_j(*args), subst=UNIT, go=GO, ge=GE, flags=JFlags(**flags),
            mesh=jmesh, w_eff=_j(w_eff)[0], **kw)
    got_s, got_tx = port_ad.band_sharded_ad_traceback(
        *args, subst=UNIT, go=GO, ge=GE, flags=ModeFlags(**flags),
        w_eff=w_eff, **kw, **CPU)
    assert isinstance(got_s, np.ndarray) and np.array_equal(got_s, want_s)
    assert got_tx == [tuple(x) for x in want_tx]
    s_codes, t_codes, s_lens, t_lens, _ = args
    for b, (ops, si, sj) in enumerate(got_tx):
        if got_s[b] < -1e29:
            assert (ops, si, sj) == ("", -1, -1)
            continue
        score, ei, ej = _rescore(ops, s_codes[b], t_codes[b], si, sj, UNIT)
        assert score == got_s[b]
        if not (flags.get("local_start") or flags.get("free_start_edges")):
            assert (si, sj) == (0, 0)
        if not (flags.get("local_end") or flags.get("free_end_edges")):
            assert (ei, ej) == (s_lens[b], t_lens[b])


@pytest.mark.parametrize("case", ["skewed", "edge_lanes"])
def test_traceback_skewed_and_edge_lanes_match_jax(rng, case):
    """``test_band_sharded_ad_traceback_skewed`` (``test_parallel.py:
    593``), and the all-mismatch edge geometry in every mode."""
    JFlags, jmesh, _, jad = _jax()
    if case == "skewed":
        args = _skewed(rng)
        runs = [(dict(local_start=True, local_end=True),
                 dict(W=128, w_eff=np.asarray([127], np.int32), halo=16))]
    else:
        args = _edge_pairs() + (np.asarray([-32, -32], np.int32),)
        runs = [(m, dict(W=64, w_eff=np.asarray([63, 63], np.int32),
                         halo=8)) for m in MODES]
    for flags, kw in runs:
        w_eff = kw.pop("w_eff")
        with jmesh:
            want_s, want_tx = jad.band_sharded_ad_traceback(
                *_j(*args), subst=UNIT, go=GO, ge=GE, flags=JFlags(**flags),
                mesh=jmesh, w_eff=_j(w_eff)[0], ckpt_chunks=2, **kw)
        got_s, got_tx = port_ad.band_sharded_ad_traceback(
            *args, subst=UNIT, go=GO, ge=GE, flags=ModeFlags(**flags),
            w_eff=w_eff, ckpt_chunks=2, **kw, **CPU)
        assert np.array_equal(got_s, want_s), flags
        assert got_tx == [tuple(x) for x in want_tx], flags
        for b, (ops, si, sj) in enumerate(got_tx):
            score, _, _ = _rescore(ops, args[0][b], args[1][b], si, sj, UNIT)
            assert score == got_s[b]
    if case == "skewed":
        assert got_s[0] > 90 and got_tx[0][0].count("M") >= 90


def test_streams_match_jax(rng):
    """The dual-pair packing and the letter streams, array for array
    (an odd batch, mixed parities, the skewed ring), and the masked
    gather that replaces the roll chain, also where its ring is too
    short and both wrap."""
    _, _, _, jad = _jax()
    for args, W, C, m in ((_case(rng, "traceback")[0], 256, 16, 2),
                          (_skewed(rng), 128, 16, 0)):
        want = jad._prep_streams(*_j(*args), None, W=W, C=C, ckpt_every=m)
        got = port_ad._prep_streams(*args, None, W=W, C=C, ckpt_every=m,
                                    device=torch.device("cpu"))
        for k, v in want.items():
            if isinstance(v, int):
                assert got[k] == v, k
            else:
                assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    from biseqt_tpu.ops.pallas_dp_ad import _shift_stream

    codes = rng.integers(0, 4, (6, 50)).astype(np.int8)
    shifts = np.asarray([-7, -1, 0, 3, 20, 49], np.int32)
    for valid, out_len in ((np.asarray([50, 40, 50, 1, 30, 50]), 64),
                           (np.asarray([50, 50, 50, 50, 50, 50]), 32)):
        want = _shift_stream(*_j(codes, shifts, valid.astype(np.int32)),
                             out_len, -1)
        got = port_ad._shift_stream(torch.from_numpy(codes),
                                    torch.from_numpy(shifts),
                                    torch.from_numpy(valid), out_len, -1)
        assert np.array_equal(got.numpy(), np.asarray(want))


def _jax_forward(rng, mode, m=2):
    """The traceback case's JAX forward pass with checkpoints, and its
    streams, on the (2, 4) mesh."""
    JFlags, jmesh, _, jad = _jax()
    args, kw = _case(rng, "traceback")
    kw = dict(W=kw["W"], w_eff=kw["w_eff"], halo=kw["halo"])
    flags = MODES[mode]
    with jmesh:
        out = jad._run_band_sharded_ad(
            *_j(*args), W=kw["W"], subst=UNIT, go=GO, ge=GE,
            flags=JFlags(**flags), mesh=jmesh, w_eff=_j(kw["w_eff"])[0],
            halo=kw["halo"], ckpt_every=m)
    p = jad._prep_streams_jit(*_j(*args), _j(kw["w_eff"])[0], W=kw["W"],
                              C=kw["halo"], ckpt_every=m)
    return args, kw, flags, [np.asarray(x) for x in out], p


@pytest.mark.parametrize("mode", range(3))
def test_checkpoints_and_window_resolve_match_jax(rng, mode):
    """The forward pass's scores, band-gathered trackers and checkpoints
    equal the JAX package's; the JAX checkpoints fed to the port's
    window re-solve give the JAX re-solve's direction bytes, window for
    window."""
    import jax.numpy as jnp

    JFlags, jmesh, _, jad = _jax()
    m = 2
    args, kw, flags, want, p = _jax_forward(rng, mode, m)
    got = port_ad._run_band_sharded_ad(
        *args, subst=UNIT, go=GO, ge=GE, flags=ModeFlags(**flags),
        ckpt_every=m, **kw, **CPU)
    for g_, w_ in zip(got, want):
        assert np.array_equal(g_.numpy(), w_)
    cks = want[-1]
    _, g = port_ad._engine_args(
        *args, kw["w_eff"], W=kw["W"], go=GO, ge=GE, subst=UNIT,
        flags=ModeFlags(**flags), mesh=None, device="cpu", halo=kw["halo"],
        A=4, ckpt_every=m)
    C = kw["halo"]
    assert cks.shape == (g.Apad // (C * m), 4, g.B2, kw["W"])
    for co in range(cks.shape[0]):
        with jmesh:
            jdirs = np.asarray(jad._resolve_window(
                jnp.asarray(cks[co]), p["s_exp"], p["t_flip"], p["dminq2"],
                p["sl2"], p["tl2"], p["lo2"], p["hi2"], jnp.asarray(UNIT),
                jnp.int32(co * C * m), W=kw["W"], Apad=g.Apad, go=GO, ge=GE,
                flags=JFlags(**flags), mesh=jmesh, halo=C, A=4,
                ckpt_every=m))
        pdirs = port_ad._resolve_window(g, torch.tensor(cks[co]),
                                        co * C * m, m)
        assert pdirs.dtype == torch.uint8
        assert np.array_equal(pdirs.numpy(), jdirs), co


def test_window_binding_matches_jax(rng):
    """``native.traceback_ad_window_batch`` on the JAX re-solve's windows,
    newest first from the JAX run's end cells: the same cursors after
    every window and the same segments as the JAX package's binding."""
    import jax.numpy as jnp
    from biseqt_tpu import native as ref_native

    JFlags, jmesh, _, jad = _jax()
    m = 2
    args, kw, flags, want, p = _jax_forward(rng, 1, m)
    scores, Me, Mo, Ae, Ao, cks = want
    s_codes, t_codes = args[0], args[1]
    B, W, C = len(s_codes), kw["W"], kw["halo"]
    Apad = cks.shape[0] * C * m
    lane_even = (np.arange(W) % 2) == 0
    dminq = np.asarray(p["dminq"])[:B]
    end = []
    for b in range(B):
        b2, q = divmod(b, 2)
        v = np.where(lane_even, Me, Mo) if q == 0 else np.where(lane_even,
                                                                 Mo, Me)
        a_ = np.where(lane_even, Ae, Ao) if q == 0 else np.where(lane_even,
                                                                  Ao, Ae)
        k = int(np.argmax(v[b2]))
        d = int(dminq[b]) + k
        end.append(((int(a_[b2][k]) + d) // 2, (int(a_[b2][k]) - d) // 2))
    cur = {name: [np.asarray([e[0] for e in end], np.int32),
                  np.asarray([e[1] for e in end], np.int32),
                  np.zeros(B, np.int32), np.zeros(B, np.int32)]
           for name in ("port", "jax")}
    stride = s_codes.shape[1] + t_codes.shape[1] + 2
    n_segments = 0
    for co in range(Apad // (C * m) - 1, -1, -1):
        with jmesh:
            win = np.asarray(jad._resolve_window(
                jnp.asarray(cks[co]), p["s_exp"], p["t_flip"], p["dminq2"],
                p["sl2"], p["tl2"], p["lo2"], p["hi2"], jnp.asarray(UNIT),
                jnp.int32(co * C * m), W=W, Apad=Apad, go=GO, ge=GE,
                flags=JFlags(**flags), mesh=jmesh, halo=C, A=4,
                ckpt_every=m)).transpose(1, 0, 2)
        got = native.traceback_ad_window_batch(
            win, co * C * m, dminq, s_codes, t_codes, *cur["port"], stride)
        ref = ref_native.traceback_ad_window_batch(
            win, co * C * m, dminq, s_codes, t_codes, *cur["jax"], stride)
        assert got == ref, co
        for x, y in zip(cur["port"], cur["jax"]):
            assert np.array_equal(x, y), co
        n_segments += sum(1 for s in got if s)
    assert cur["port"][3].all() and n_segments > B


def test_window_binding_refuses_bad_cursors():
    dirs = np.zeros((1, 4, 8), np.uint8)
    s = np.zeros((2, 5), np.int8)
    ok = lambda: [np.zeros(2, np.int32) for _ in range(4)]
    cur = ok()
    native.traceback_ad_window_batch(dirs, 0, [0, 1], s, s, *cur, 12)
    cur = ok()
    cur[0] = cur[0].astype(np.int64)
    with pytest.raises(ValueError, match="int32"):
        native.traceback_ad_window_batch(dirs, 0, [0, 1], s, s, *cur, 12)
    cur = ok()
    cur[1][1] = 6                          # past the pair's 5 letters
    with pytest.raises(ValueError, match="outside"):
        native.traceback_ad_window_batch(dirs, 0, [0, 1], s, s, *cur, 12)
    with pytest.raises(ValueError, match="pairs"):
        native.traceback_ad_window_batch(dirs, 0, [0, 1], np.zeros(
            (3, 5), np.int8), np.zeros((3, 5), np.int8),
            *[np.zeros(3, np.int32) for _ in range(4)], 12)
    with pytest.raises(ValueError, match="ops_stride"):
        native.traceback_ad_window_batch(dirs, 0, [0, 1], s, s, *ok(), 11)


def test_engines_refuse_a_mesh_on_another_device(rng):
    args, kw = _case(rng, "edge_lanes")

    class OnCard:
        shape = {"data": 1, "band": 1}
        device = torch.device("cuda", 0)

    for fn in (banded_dp_band_sharded, port_ad.banded_dp_band_sharded_ad,
               port_ad.band_sharded_ad_traceback):
        with pytest.raises(ValueError, match="mesh on"):
            fn(*args, subst=UNIT, go=GO, ge=GE, flags=ModeFlags(),
               mesh=OnCard(), **kw, **CPU)
    with pytest.raises(ValueError, match="affine gap"):
        banded_dp_band_sharded(*args, subst=UNIT, go=1.0, ge=GE,
                               flags=ModeFlags(), **kw, **CPU)


def test_mesh_band_axis_world_of_one():
    m = make_mesh(**CPU)
    assert m.band_rank == 0 and m.band_group is None
    assert m.band_peer(0) == 0
    with pytest.raises(ValueError):
        m.band_peer(1)


# ---------------------------------------------------------------------------
# gloo worlds of 2 and 4 ranks
# ---------------------------------------------------------------------------

WORLD_CASES = ("traceback", "ad_edge_lanes")


def _world_run(data, mesh):
    """Every engine, every mode, on both inputs: a dict of scores and
    transcripts keyed by engine, input and mode."""
    out = {}
    for name in WORLD_CASES:
        args = tuple(data[name + "_" + k]
                     for k in ("s", "t", "sl", "tl", "dmin"))
        W, halo = int(data[name + "_W"]), int(data[name + "_halo"])
        w_eff = data[name + "_weff"]
        for mi, mode in enumerate(MODES):
            kw = dict(W=W, subst=UNIT, go=GO, ge=GE, flags=ModeFlags(**mode),
                      mesh=mesh, device="cpu")
            key = "%s/%d/" % (name, mi)
            out[key + "row"] = banded_dp_band_sharded(
                *args, w_eff=w_eff + 1, **kw).tolist()
            out[key + "ad"] = port_ad.banded_dp_band_sharded_ad(
                *args, w_eff=w_eff, halo=halo, **kw).tolist()
            s, tx = port_ad.band_sharded_ad_traceback(
                *args, w_eff=w_eff, halo=halo, ckpt_chunks=2, **kw)
            out[key + "tb"] = [s.tolist(), [list(x) for x in tx]]
    return out


def _world_worker(rank, world, store, inputs, out_dir, meshes):
    """One rank of a gloo world: each mesh in turn, every engine on
    every input; results to ``out_dir/rank<r>.json``.  One thread a rank:
    the ranks' intra-op pools would otherwise contend for the cores and
    every exchange would wait on a descheduled peer."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        data = dict(np.load(inputs))
        res = {}
        for n_data, n_band in meshes:
            mesh = make_mesh(n_data=n_data, n_band=n_band, device="cpu")
            assert mesh.shape == {"data": n_data, "band": n_band}
            assert mesh.band_rank == rank % n_band
            assert mesh.data_rank == rank // n_band
            assert mesh.band_peer(mesh.band_rank) == rank
            res["%dx%d" % (n_data, n_band)] = _world_run(data, mesh)
            if n_band > 1:
                try:
                    banded_dp_band_sharded(
                        *(data["traceback_" + k]
                          for k in ("s", "t", "sl", "tl", "dmin")),
                        W=255, subst=UNIT, go=GO, ge=GE, flags=ModeFlags(),
                        mesh=mesh, device="cpu")
                    res["%dx%d" % (n_data, n_band)]["W % nb"] = "no raise"
                except ValueError as e:
                    res["%dx%d" % (n_data, n_band)]["W % nb"] = str(e)
        with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _world_inputs(rng):
    data = {}
    for name in WORLD_CASES:
        args, kw = _case(rng, name)
        for k, v in zip(("s", "t", "sl", "tl", "dmin"), args):
            data[name + "_" + k] = v
        data[name + "_W"] = np.asarray(kw["W"])
        data[name + "_halo"] = np.asarray(min(kw["halo"], 16))
        data[name + "_weff"] = kw["w_eff"]
    return data


@pytest.mark.parametrize("world,meshes", [(2, [(1, 2)]),
                                          (4, [(1, 4), (2, 2)])])
def test_world_matches_world_of_one(tmp_path, rng, world, meshes):
    """Both score engines and the traceback on gloo worlds (band axis 2
    and 4, and 2 x 2 with the inputs replicated over the data axis):
    every rank's scores and transcripts equal the world of one's, and a
    W that does not divide by the band axis raises on every rank."""
    data = _world_inputs(rng)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, **data)
    want = json.loads(json.dumps(_world_run(data, make_mesh(**CPU))))
    ctx = mp.spawn(_world_worker,
                   args=(world, str(tmp_path / "store"), inputs,
                         str(tmp_path), meshes),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo world did not finish in %d s"
                        % SPAWN_TIMEOUT_S)
    assert not any(p.is_alive() for p in ctx.processes)
    for r in range(world):
        with open(str(tmp_path / ("rank%d.json" % r))) as f:
            got = json.load(f)
        assert sorted(got) == sorted("%dx%d" % m for m in meshes)
        for mesh_name, res in got.items():
            assert "must divide" in res.pop("W % nb")
            assert res == want, (r, mesh_name)


# ---------------------------------------------------------------------------
# the checkpointed sweep
# ---------------------------------------------------------------------------

def _sweep_reads(rng, **kw):
    from biseqt_tpu.sequence import pack_sequences
    from test_torch_allvsall import reads_with_overlaps

    reads, _ = reads_with_overlaps(rng, **kw)
    return pack_sequences(reads, pad_to=512)


def _assert_stats(got, want, exact_floats=False):
    for k in ("num_seeds", "diag", "olap_len"):
        assert np.array_equal(got[k], np.asarray(want[k])), k
    for k in ("p", "s0"):
        if exact_floats:
            assert np.array_equal(got[k], np.asarray(want[k])), k
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_sweep_resumes_and_matches_one_block(tmp_path, rng):
    """``test_checkpointed_sweep_resumes`` (``test_parallel.py:159``):
    three blocks written, one deleted and resumed bit for bit, and the
    whole equal to one ``overlap_stats_block`` call."""
    from biseqt_tpu_torch.parallel.allvsall import overlap_stats_block

    codes, lens = _sweep_reads(rng, n_reads=6, glen=1200, rlen=400)
    out_dir = str(tmp_path / "sweep")
    seen = []
    full = checkpointed_overlap_sweep(codes, lens, out_dir, wordlen=6,
                                      block=2, device="cpu",
                                      progress=lambda *a: seen.append(a))
    assert seen == [(1, 3), (2, 3), (3, 3)]
    blocks = sorted(f for f in os.listdir(out_dir) if f.startswith("block_"))
    assert blocks == ["block_00000.npz", "block_00001.npz", "block_00002.npz"]
    os.remove(os.path.join(out_dir, blocks[1]))
    again = checkpointed_overlap_sweep(codes, lens, out_dir, wordlen=6,
                                       block=2, device="cpu")
    for k in full:
        assert full[k].shape == (6, 6) and np.array_equal(full[k], again[k])
    direct = {k: v.numpy() for k, v in overlap_stats_block(
        codes, lens, codes, lens, wordlen=6, device="cpu").items()}
    _assert_stats(full, direct)


def test_sweep_matches_jax_and_resumes_its_directory(tmp_path, rng):
    """The port's sweep equals the JAX package's; a sweep the JAX package
    stopped after two of four blocks is finished by the port (the JAX
    blocks kept as written), and one the port stopped is finished by the
    JAX package."""
    from biseqt_tpu.parallel.sweep import checkpointed_overlap_sweep as jax_sweep

    codes, lens = _sweep_reads(rng, n_reads=7, glen=1600, rlen=400)
    kw = dict(wordlen=6, block=2)
    want = jax_sweep(codes, lens, str(tmp_path / "jax"), **kw)
    got = checkpointed_overlap_sweep(codes, lens, str(tmp_path / "port"),
                                     device="cpu", **kw)
    _assert_stats(got, want)

    class Stop(Exception):
        pass

    def stop_after_two(done, total):
        assert total == 4
        if done == 2:
            raise Stop

    for first, second, name in ((jax_sweep, checkpointed_overlap_sweep,
                                 "jax_then_port"),
                                (checkpointed_overlap_sweep, jax_sweep,
                                 "port_then_jax")):
        out_dir = str(tmp_path / name)
        dev = lambda fn: CPU if fn is checkpointed_overlap_sweep else {}
        with pytest.raises(Stop):
            first(codes, lens, out_dir, progress=stop_after_two,
                  **dev(first), **kw)
        assert sorted(os.listdir(out_dir)) == [
            "block_00000.npz", "block_00001.npz", "manifest.json"]
        early = {}
        for f in ("block_00000.npz", "block_00001.npz"):
            with open(os.path.join(out_dir, f), "rb") as fh:
                early[f] = fh.read()
        res = second(codes, lens, out_dir, **dev(second), **kw)
        for f, b in early.items():
            with open(os.path.join(out_dir, f), "rb") as fh:
                assert fh.read() == b, f
        # rows 0-3 are the first package's blocks, rows 4-6 the second's,
        # each bit for bit; the whole within tolerance of both sweeps
        by_first, by_second = ((want, got) if name == "jax_then_port"
                               else (got, want))
        for k in res:
            assert np.array_equal(res[k][:4], np.asarray(by_first[k])[:4]), k
            assert np.array_equal(res[k][4:], np.asarray(by_second[k])[4:]), k
        _assert_stats(res, want)
        _assert_stats(res, got)


def test_sweep_refuses_another_sweeps_directory(tmp_path, rng):
    codes, lens = _sweep_reads(rng, n_reads=6, glen=1200, rlen=400)
    out_dir = str(tmp_path / "sweep")
    checkpointed_overlap_sweep(codes, lens, out_dir, wordlen=6, block=3,
                               device="cpu")
    for kw in (dict(wordlen=7, block=3), dict(wordlen=6, block=2),
               dict(wordlen=6, block=3, max_hits=2)):
        with pytest.raises(ValueError, match="different sweep"):
            checkpointed_overlap_sweep(codes, lens, out_dir, device="cpu",
                                       **kw)
    with pytest.raises(ValueError, match="different sweep"):
        checkpointed_overlap_sweep(codes[:5], lens[:5], out_dir, wordlen=6,
                                   block=3, device="cpu")
    # a manifest written before alphabet_len was recorded still matches
    path = os.path.join(out_dir, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    del manifest["alphabet_len"]
    with open(path, "w") as f:
        json.dump(manifest, f)
    checkpointed_overlap_sweep(codes, lens, out_dir, wordlen=6, block=3,
                               device="cpu")
