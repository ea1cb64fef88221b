"""The port's row-wavefront reference engine
(biseqt_tpu_torch.ops.banded_dp) against the JAX package's lax engine
(biseqt_tpu.ops.banded_dp) and the numpy oracle (tests/oracle.py).

The same numpy inputs go through both engines.  Tolerance is exact
everywhere: scores, end cells and direction bytes equal, transcripts
identical.  Integer and dyadic scores (go = -2.5, ge = -1 or -0.5) keep
every sum exact, so both engines round nothing and any difference is a
difference of recurrence, masking or tie order.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from biseqt_tpu.ops import banded_dp as ref
from biseqt_tpu_torch.ops import banded_dp as port

from oracle import dp_oracle

UNIT = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
GENERAL = np.array(
    [[2, -1, -2, -1], [-1, 2, -1, -2], [-2, -1, 2, -1], [-1, -2, -1, 2]],
    np.float32)

# the alntype family: the seven STD_MODE flag sets, the first three of
# which are also the BANDED_MODE ones
STD_FLAGS = [
    dict(),
    dict(local_start=True, local_end=True),
    dict(free_start_edges=True, free_end_edges=True),
    dict(local_end=True),
    dict(local_start=True),
    dict(free_end_edges=True),
    dict(free_start_edges=True),
]
BANDED_FLAGS = STD_FLAGS[:3]


def mk_pairs(rng, B=4, LS=90, LT=100):
    """Ragged homologous pairs (15% substitutions, T shifted by up to
    three letters), PAD (-1) past each length."""
    ss = rng.integers(0, 4, (B, LS)).astype(np.int8)
    ts = np.zeros((B, LT), np.int8)
    ts[:, :LS] = ss
    m = rng.random((B, LT)) < 0.15
    ts[m] = (ts[m] + 1 + rng.integers(0, 3, m.sum())) % 4
    for b in range(B):
        ts[b] = np.roll(ts[b], b % 4)
    s_lens = np.array([LS, LS - 13, LS - 30, 1][:B], np.int32)
    t_lens = np.array([LT, LT - 27, LT - 5, LT][:B], np.int32)
    for b in range(B):
        ss[b, s_lens[b]:] = -1
        ts[b, t_lens[b]:] = -1
    return ss, ts, s_lens, t_lens


def jx(*xs):
    return [jnp.asarray(x) for x in xs]


def assert_same(r, g):
    for name, a, b in zip(r._fields, r, g):
        a = np.asarray(a)
        if name == "dirs" and a.ndim == 0:
            assert b.numel() == 0
            continue
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.mark.parametrize("flags", STD_FLAGS)
def test_full_dp_and_tracebacks_match_lax(rng, flags):
    """full_dp with and without directions, the checkpointed re-solve
    traceback (several blocks) and the host walk, all modes."""
    args = mk_pairs(rng)
    kw = dict(subst=UNIT, go=-2.5, ge=-1.0)
    f_ref, f_port = ref.ModeFlags(**flags), port.ModeFlags(**flags)
    r = ref.full_dp(*jx(*args), flags=f_ref, with_dirs=True, **kw)
    g = port.full_dp(*args, flags=f_port, with_dirs=True, device="cpu",
                     **kw)
    assert_same(r, g)
    assert_same(ref.full_dp(*jx(*args), flags=f_ref, **kw),
                port.full_dp(*args, flags=f_port, device="cpu", **kw))
    want = ref.full_dp_traceback(*jx(*args), flags=f_ref,
                                 end_i=np.asarray(r.end_i),
                                 end_j=np.asarray(r.end_j), block_rows=32,
                                 **kw)
    got = port.full_dp_traceback(*args, flags=f_port, end_i=g.end_i,
                                 end_j=g.end_j, block_rows=32,
                                 device="cpu", **kw)
    assert got == want
    ss, ts = args[:2]
    for b in range(len(ss)):
        walk = port.traceback_path(g.dirs[b], ss[b], ts[b], int(g.end_i[b]),
                                   int(g.end_j[b]), banded=False,
                                   flags=f_port)
        assert walk == got[b]
        assert walk == ref.traceback_path(
            np.asarray(r.dirs[b]), ss[b], ts[b], int(r.end_i[b]),
            int(r.end_j[b]), banded=False, flags=f_ref)


@pytest.mark.parametrize("flags", BANDED_FLAGS)
@pytest.mark.parametrize("subst,ge", [(UNIT, -1.0), (GENERAL, -0.5)])
def test_banded_dp_matches_lax(rng, flags, subst, ge):
    """A ragged batch with per-pair bands and effective widths below W
    (dead lanes), unit and general scores; directions and walks."""
    args = mk_pairs(rng)
    dmin = np.array([-20, -30, -5, -40], np.int32)
    w_eff = np.array([48, 33, 40, 48], np.int32)
    kw = dict(W=48, subst=subst, go=-2.5, ge=ge)
    f_ref, f_port = ref.ModeFlags(**flags), port.ModeFlags(**flags)
    r = ref.banded_dp(*jx(*args, dmin), flags=f_ref, with_dirs=True,
                      w_eff=jnp.asarray(w_eff), **kw)
    g = port.banded_dp(*args, dmin, flags=f_port, with_dirs=True,
                       w_eff=w_eff, device="cpu", **kw)
    assert_same(r, g)
    assert_same(ref.banded_dp(*jx(*args, dmin), flags=f_ref,
                              w_eff=jnp.asarray(w_eff), **kw),
                port.banded_dp(*args, dmin, flags=f_port, w_eff=w_eff,
                               device="cpu", **kw))
    ss, ts = args[:2]
    for b in range(len(ss)):
        if float(g.score[b]) <= -1e29:
            continue
        dmax = int(dmin[b]) + 47
        assert port.traceback_path(
            g.dirs[b], ss[b], ts[b], int(g.end_i[b]), int(g.end_j[b]),
            banded=True, dmax=dmax, flags=f_port,
        ) == ref.traceback_path(
            np.asarray(r.dirs[b]), ss[b], ts[b], int(r.end_i[b]),
            int(r.end_j[b]), banded=True, dmax=dmax, flags=f_ref)
    assert float(g.score.max()) > 30


def test_banded_dp_negative_dmax_long_t(rng):
    """A band entirely left of the main diagonal (dmax < 0) over a T much
    longer than S, the homology planted far right in T."""
    B, LS, LT, W = 2, 120, 640, 128
    ss = rng.integers(0, 4, (B, LS)).astype(np.int8)
    ts = rng.integers(0, 4, (B, LT)).astype(np.int8)
    ts[:, 300:300 + LS] = ss
    args = (ss, ts, np.full((B,), LS, np.int32), np.full((B,), LT, np.int32),
            np.full((B,), -420, np.int32))
    w_eff = np.full((B,), W - 1, np.int32)
    for flags in BANDED_FLAGS[1:]:
        r = ref.banded_dp(*jx(*args), W=W, subst=UNIT, go=-2.0, ge=-1.0,
                          flags=ref.ModeFlags(**flags), with_dirs=True,
                          w_eff=jnp.asarray(w_eff))
        g = port.banded_dp(*args, W=W, subst=UNIT, go=-2.0, ge=-1.0,
                           flags=port.ModeFlags(**flags), with_dirs=True,
                           w_eff=w_eff, device="cpu")
        assert_same(r, g)
        assert float(g.score[0]) > 100    # the planted diagonal is in band


@pytest.mark.parametrize("flags", STD_FLAGS)
def test_engine_matches_oracle(rng, flags):
    """Banded (a band narrower than the matrix) and full solves against
    the cell-by-cell numpy oracle."""
    ss, ts, s_lens, t_lens = mk_pairs(rng, B=3, LS=40, LT=44)
    kw = dict(subst=UNIT, go=-2.5, ge=-1.0, flags=port.ModeFlags(**flags),
              device="cpu")
    full = port.full_dp(ss, ts, s_lens, t_lens, **kw).score.numpy()
    dmin = np.full((3,), -9, np.int32)
    banded = port.banded_dp(ss, ts, s_lens, t_lens, dmin, W=16,
                            **kw).score.numpy()
    for b in range(3):
        s, t = ss[b, :s_lens[b]], ts[b, :t_lens[b]]
        assert full[b] == dp_oracle(s, t, UNIT, -2.5, -1.0, **flags)
        want = dp_oracle(s, t, UNIT, -2.5, -1.0, dmin=-9, dmax=6, **flags)
        assert banded[b] == np.float32(max(want, port.NEG))


def test_row0_ends_and_empty_origin():
    """Row 0 cells are alignment ends (free end at H[0][1], local end at
    H[0][0]); an empty origin aligns globally as one gap (the cases of
    tests/test_pw.py::test_row0_alignment_ends)."""
    subst = np.full((4, 4), -100.0, np.float32)
    s = np.array([[2, 2]], np.int8)
    t = np.array([[0, 0]], np.int8)
    sl, sl0, tl = [2], [0], [1]
    dmin = [-4]
    kw = dict(subst=subst, go=-2.0, ge=-1.0, device="cpu")
    F = port.ModeFlags
    cases = [
        (port.full_dp(s, t, sl, tl, flags=F(free_end_edges=True), **kw),
         -3.0),
        (port.banded_dp(s, t, sl, tl, dmin, W=8, flags=F(free_end_edges=True),
                        **kw), -3.0),
        (port.full_dp(s, t, sl, tl, flags=F(free_start_edges=True,
                                            free_end_edges=True), **kw), 0.0),
        (port.full_dp(s, t, sl, tl, flags=F(local_end=True), **kw), 0.0),
        (port.full_dp(s, t, sl0, tl, flags=F(), **kw), -3.0),
        (port.banded_dp(s, t, sl0, tl, dmin, W=8, flags=F(), **kw), -3.0),
    ]
    for res, want in cases:
        assert float(res.score[0]) == want


def test_positive_gap_scores_and_off_band_walks_raise():
    s = np.array([[0]], np.int8)
    t = np.array([[0, 1, 2]], np.int8)
    with pytest.raises(ValueError, match="go <= 0"):
        port.banded_dp(s, t, [1], [3], [-4], W=8, subst=UNIT, go=1.0,
                       ge=-1.0, flags=port.ModeFlags(), device="cpu")
    with pytest.raises(ValueError, match="left the direction plane"):
        port.traceback_path(np.ones((1, 8), np.uint8), s[0], t[0], 1, 3,
                            banded=True, dmax=-10)
