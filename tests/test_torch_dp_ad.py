"""The port's antidiagonal DP (biseqt_tpu_torch.ops.dp_ad) against the
JAX package's Pallas kernel in interpret mode.

Reruns the cases of tests/test_pallas_dp_ad.py with the same numpy
inputs through both.  Tolerance is exact everywhere: scores bit for bit
(fractional ones included), end cells equal, and dirs nibbles equal on
every live slot of the plane.  The CUDA kernel is held to this plain
twin on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from biseqt_tpu.ops.banded_dp import ModeFlags as RefFlags, banded_dp
from biseqt_tpu.ops.pallas_dp_ad import banded_dp_pallas_ad
from biseqt_tpu_torch import native
from biseqt_tpu_torch.ops import dp_ad
from biseqt_tpu_torch.ops.dp_ad import (banded_dp_ad, live_nibbles,
                                        parity_adjusted_dmin)
from biseqt_tpu_torch.sequence import from_reference
from test_pallas_dp_ad import _rescore
from test_torch_cuda import (UNIT, launches, mk_batch, mk_edge_batch,
                             random_subst)

FLAG_CASES = [
    dict(local_start=True, local_end=True),
    dict(),
    dict(free_start_edges=True, free_end_edges=True),
]


def run_both(args, w_eff, *, subst, go, ge, flags, W=128, with_dirs=True):
    """The same inputs through the JAX kernel (interpret mode, small
    chunks, told the alphabet's size) and the port on the CPU; returns
    ``(reference, port)``."""
    ref = banded_dp_pallas_ad(
        *[jnp.asarray(x) for x in args], W=W, subst=subst, go=go, ge=ge,
        flags=RefFlags(**flags), w_eff=jnp.asarray(w_eff), interpret=True,
        block_b=8, r_chunk=16, with_dirs=with_dirs, A=len(subst))
    got = banded_dp_ad(
        *args, W=W, subst=subst, go=go, ge=ge,
        flags=from_reference(RefFlags(**flags)), w_eff=w_eff,
        with_dirs=with_dirs, r_chunk=16, device="cpu")
    return ref, got


def assert_same(ref, got, dmin, w_eff, W=128):
    """Exact parity: scores, end cells, dirs nibbles on live slots."""
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(got.end_i.numpy(), np.asarray(ref.end_i))
    np.testing.assert_array_equal(got.end_j.numpy(), np.asarray(ref.end_j))
    if got.dirs.numel() == 0:
        return
    rd = np.asarray(ref.dirs)
    gd = got.dirs.numpy()
    B2 = (len(dmin) + 1) // 2
    assert gd.shape == (rd.shape[0], B2, W)
    rd = rd[:, :B2]
    lo_live, hi_live = (m.numpy() for m in live_nibbles(
        torch.as_tensor(dmin), torch.as_tensor(w_eff), W))
    np.testing.assert_array_equal((gd & 15)[:, lo_live], (rd & 15)[:, lo_live])
    np.testing.assert_array_equal((gd >> 4)[:, hi_live], (rd >> 4)[:, hi_live])


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_dp_ad_matches_pallas(rng, flags):
    args, w_eff = mk_batch(rng)
    ref, got = run_both(args, w_eff, subst=UNIT, go=-2.0, ge=-1.0,
                        flags=flags)
    assert_same(ref, got, args[4], w_eff)
    # score-only: the same scores, -1 end sentinels, no plane
    plain = banded_dp_ad(*args, W=128, subst=UNIT, go=-2.0, ge=-1.0,
                         flags=dp_ad.ModeFlags(**flags), w_eff=w_eff,
                         r_chunk=16, device="cpu")
    np.testing.assert_array_equal(plain.score.numpy(), np.asarray(ref.score))
    assert (plain.end_i.numpy() == -1).all() and plain.dirs.numel() == 0


def test_dp_ad_no_wrap_phantom(rng):
    """Rich bottom-edge diagonal plus the global corner on the top edge:
    without the E/F wrap masks the score is a phantom 176, not 72."""
    X = rng.integers(0, 4, 200).astype(np.int8)
    Z = rng.integers(0, 4, 126).astype(np.int8)
    S = np.concatenate([X, Z])[None, :]
    T = np.pad(X, (0, 126), constant_values=0)[None, :]
    args = (S, T, np.array([326], np.int32), np.array([200], np.int32),
            np.array([-1], np.int32))
    w_eff = np.array([127], np.int32)
    ref, got = run_both(args, w_eff, subst=UNIT, go=-2.0, ge=-1.0, flags={})
    assert_same(ref, got, args[4], w_eff)
    oracle = banded_dp(*[jnp.asarray(x) for x in args], W=128, subst=UNIT,
                       go=-2.0, ge=-1.0, flags=RefFlags(),
                       w_eff=jnp.asarray(w_eff))
    assert float(got.score[0]) == float(np.asarray(oracle.score)[0])


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_dp_ad_dirs_transcripts(rng, flags):
    """The port's plane, walked by the shared C++ host walker, gives the
    transcripts the JAX plane gives, and they rescore to the score."""
    from biseqt_tpu import native as ref_native

    args, w_eff = mk_batch(rng)
    ref, got = run_both(args, w_eff, subst=UNIT, go=-2.0, ge=-1.0,
                        flags=flags)
    ss, ts, s_lens, t_lens, dmin = args
    B = len(ss)
    dminq = parity_adjusted_dmin(dmin, np.arange(B, dtype=np.int32) % 2)
    f = RefFlags(**flags)
    ops, si, sj = native.traceback_batch_ad(
        got.dirs.numpy(), dminq, ss, ts, s_lens, t_lens,
        got.end_i.numpy(), got.end_j.numpy(), f)
    r_ops, r_si, r_sj = ref_native.traceback_batch_ad(
        np.asarray(ref.dirs), dminq, ss, ts, s_lens, t_lens,
        np.asarray(ref.end_i), np.asarray(ref.end_j), f)
    score = got.score.numpy()
    for b in range(B):
        if score[b] < -1e29:
            continue
        assert ops[b] == r_ops[b] and (si[b], sj[b]) == (r_si[b], r_sj[b])
        rescored, _, _ = _rescore(ops[b], ss[b], ts[b], si[b], sj[b], UNIT,
                                  -2.0, -1.0)
        assert rescored == score[b], (b, flags)


def test_dp_ad_general_subst_fractional_ge(rng):
    """Non-uniform substitution and a fractional ge: the drifted
    arithmetic must round exactly as the reference's."""
    args, w_eff = mk_batch(rng)
    subst = np.array(
        [[2, -1, -2, -1], [-1, 2, -1, -2], [-2, -1, 2, -1], [-1, -2, -1, 2]],
        np.float32)
    for flags in (dict(local_start=True, local_end=True),
                  dict(free_start_edges=True, local_end=True)):
        ref, got = run_both(args, w_eff, subst=subst, go=-3.0, ge=-0.5,
                            flags=flags)
        assert_same(ref, got, args[4], w_eff)


def test_dp_ad_row0_and_empty_origin():
    """Free-end optimum on row 0, and an empty-origin global pair."""
    subst = np.full((4, 4), -100.0, np.float32)
    s = np.array([[2, 2]], np.int8)
    t = np.array([[0, 0]], np.int8)
    w_eff = np.array([127], np.int32)
    for sl_v, flags in ((2, dict(free_end_edges=True)), (0, dict())):
        args = (s, t, np.array([sl_v], np.int32), np.array([1], np.int32),
                np.array([-64], np.int32))
        ref, got = run_both(args, w_eff, subst=subst, go=-2.0, ge=-1.0,
                            flags=flags)
        assert_same(ref, got, args[4], w_eff)
        assert float(got.score[0]) == -3.0


def test_dp_ad_skewed_lengths(rng):
    """A 100-char T banding deep into a 600-char S (dmin = 480)."""
    S = rng.integers(0, 4, 600).astype(np.int8)
    T = np.pad(S[481:581], (0, 28), constant_values=0)[None, :]
    args = (S[None, :], T, np.array([600], np.int32),
            np.array([100], np.int32), np.array([480], np.int32))
    w_eff = np.array([127], np.int32)
    for flags in (dict(local_start=True, local_end=True),
                  dict(free_start_edges=True, free_end_edges=True)):
        ref, got = run_both(args, w_eff, subst=UNIT, go=-2.0, ge=-1.0,
                            flags=flags)
        assert_same(ref, got, args[4], w_eff)
        assert float(got.score[0]) > 90


def test_cuda_device_never_falls_back_to_cpu(rng):
    """Asked for the card where there is none, the wrappers raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs it")
    args, w_eff = mk_batch(rng)
    with pytest.raises((AssertionError, RuntimeError)):
        banded_dp_ad(*args, W=128, subst=UNIT, go=-2.0, ge=-1.0,
                     flags=dp_ad.ModeFlags(), w_eff=w_eff, device="cuda")
    from biseqt_tpu_torch.ops.walk import traceback_walk
    with pytest.raises((AssertionError, RuntimeError)):
        traceback_walk(torch.zeros((4, 3, 128), dtype=torch.uint8),
                       np.zeros(6, np.int32), np.ones(6, np.int32),
                       np.ones(6, np.int32), W=128, device="cuda")


def test_dp_ad_rejects_bad_input(rng):
    args, w_eff = mk_batch(rng)
    kw = dict(W=128, subst=UNIT, go=-2.0, ge=-1.0,
              flags=dp_ad.ModeFlags(), w_eff=w_eff, device="cpu")
    with pytest.raises(ValueError, match="nonpositive"):
        banded_dp_ad(*args, **dict(kw, go=1.0))
    bad = args[0].copy()
    bad[0, 0] = 4
    with pytest.raises(ValueError, match="alphabet"):
        banded_dp_ad(bad, *args[1:], **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        banded_dp_ad(*args, **dict(kw, device="meta"))


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_dp_ad_band_of_4096_lanes_matches_lax(rng, flags):
    """W 4096, the widest K1 band, against the JAX kernel (interpret mode)
    and the JAX lax engine at the same W: the batch's bands sit at the
    top of the lanes (as at W 128) and one pair's band spans every lane.
    Scores, end cells and the dirs plane's live nibbles equal the JAX
    kernel's; scores and end cells equal the lax engine's."""
    args, w_eff = mk_batch(rng)
    W = 4096
    dmin = args[4] + 128 - W
    dmin[2], w_eff[2] = -W // 2, W - 1
    args = (*args[:4], dmin)
    ref, got = run_both(args, w_eff, subst=UNIT, go=-2.0, ge=-1.0,
                        flags=flags, W=W)
    assert_same(ref, got, dmin, w_eff, W=W)
    assert float(got.score.max()) > 60
    lax = banded_dp(*[jnp.asarray(x) for x in args], W=W, subst=UNIT,
                    go=-2.0, ge=-1.0, flags=RefFlags(**flags),
                    w_eff=jnp.asarray(w_eff))
    for name in ("score", "end_i", "end_j"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(lax, name)))


def test_dp_ad_band_of_6144_lanes_matches_pallas(rng):
    """W 6144, a band the card runs as a cluster of blocks, against the
    JAX kernel (interpret mode): the batch's bands sit at the top of the
    lanes and one pair's band spans every lane.  Scores, end cells and
    the dirs plane's live nibbles are equal."""
    args, w_eff = mk_batch(rng)
    W = 6144
    dmin = args[4] + 128 - W
    dmin[2], w_eff[2] = -W // 2, W - 1
    args = (*args[:4], dmin)
    ref, got = run_both(args, w_eff, subst=UNIT, go=-2.0, ge=-1.0,
                        flags=FLAG_CASES[0], W=W)
    assert_same(ref, got, dmin, w_eff, W=W)
    assert float(got.score.max()) > 60


def test_dp_ad_40_letter_alphabet_matches_pallas(rng):
    """A random 40 x 40 matrix (fractional mismatches) against the JAX
    kernel (interpret mode; its packed-table path, ~40 s here, so one
    mode): scores, end cells, live nibbles."""
    flags = FLAG_CASES[0]
    lanes = [60, 64, 10, 120]
    ss, ts, s_lens, t_lens = mk_edge_batch(rng, lanes, L=90, A=40)
    args = (ss, ts, s_lens, t_lens, -np.array(lanes, np.int32))
    w_eff = np.full(len(lanes), 127, np.int32)
    ref, got = run_both(args, w_eff, subst=random_subst(rng, 40), go=-3.0,
                        ge=-0.5, flags=flags)
    assert_same(ref, got, args[4], w_eff)
    assert float(got.score.max()) > 100


def test_dp_ad_widths_the_kernel_refuses(rng):
    """Above 2048 lanes W must be a multiple of 4 and above 4096 of 128
    (the twin takes every other even W); the kernel's wrapper refuses
    bands above MAX_W before it loads anything, naming the cap and the
    routes that take any W."""
    args, w_eff = mk_batch(rng)
    kw = dict(subst=UNIT, go=-2.0, ge=-1.0, flags=dp_ad.ModeFlags(),
              w_eff=w_eff, device="cpu")
    for W in (4100, 3074):
        with pytest.raises(ValueError, match="W must be even"):
            banded_dp_ad(*args, W=W, **kw)
    W = dp_ad.MAX_W + 8192
    g = dp_ad._geometry(*args, w_eff, W=W, subst=UNIT, go=-2.0, ge=-1.0,
                        r_chunk=16, device=torch.device("cpu"))
    n0 = launches("dp_ad")
    with pytest.raises(ValueError, match="MAX_W = 65536.*use_pallas=False"
                       ".*band_sharded_ad_traceback"):
        dp_ad._sweep_cuda(g, dp_ad.ModeFlags(), True)
    assert launches("dp_ad") == n0
