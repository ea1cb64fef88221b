"""The port's row-form DP (biseqt_tpu_torch.ops.dp_row, K4) against the
JAX package's row kernel and lax engine.

Two cases hold the plain twin to the Pallas kernel itself
(``banded_dp_pallas`` in interpret mode, one 128-row chunk, 8 pairs):
every output, the whole direction plane included, must be equal.  The
interpret mode is slow (the reference marks all of
tests/test_pallas_dp.py slow for it), so every other case holds the twin
to the JAX lax engine, as tests/test_pallas_dp.py holds the kernel:
scores and end cells exactly, transcripts identical, and the direction
bytes exactly wherever the two recipes agree by construction (all modes
but ``local_start``, where the kernel floors lanes outside the matrix).
The CUDA kernel is held to this twin on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from biseqt_tpu.matrices import BLOSUM62
from biseqt_tpu.ops.banded_dp import ModeFlags as RefFlags, banded_dp
from biseqt_tpu.ops.pallas_dp import banded_dp_pallas
from biseqt_tpu.sequence import Alphabet, pack_sequences
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch.ops import dp_row
from biseqt_tpu_torch.ops.banded_dp import ModeFlags, traceback_path
from biseqt_tpu_torch.ops.dp_row import banded_dp_row

from test_torch_cuda import (ROW_FLAGS, UNIT, mk_edge_batch, mk_row_batch,
                             random_subst)

A4 = Alphabet("ACGT")


def jx(*xs):
    return [jnp.asarray(x) for x in xs]


def assert_same(ref, got, dirs=True):
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(got.end_i.numpy(), np.asarray(ref.end_i))
    np.testing.assert_array_equal(got.end_j.numpy(), np.asarray(ref.end_j))
    if dirs:
        np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(ref.dirs))


def homologous(rng, B, n, pad_to, alphabet=A4):
    M = MutationProcess(alphabet, subst_probs=0.15, go_prob=0.05,
                        ge_prob=0.2, rng=rng)
    ss, ts = [], []
    for _ in range(B):
        S = rand_seq(alphabet, n, rng=rng)
        T, _ = M.mutate(S)
        ss.append(S)
        ts.append(T)
    s_codes, s_lens = pack_sequences(ss, pad_to=pad_to)
    t_codes, t_lens = pack_sequences(ts, pad_to=pad_to)
    return s_codes, t_codes, s_lens, t_lens


@pytest.mark.parametrize("with_dirs,flags", [
    (False, dict(free_start_edges=True, free_end_edges=True)),
    (True, dict(local_start=True, local_end=True)),
])
def test_dp_row_matches_interpret_kernel(rng, with_dirs, flags):
    """The twin against the TPU kernel in interpret mode: ragged pairs,
    per-pair bands, dead lanes, a fractional gap open.  The directions
    case is local, where the kernel's bytes depart from the lax
    engine's, so only this case holds them to the JAX package."""
    args, w_eff = mk_row_batch(rng, L=100)
    args = [np.concatenate([a, a[:3]]) for a in args]        # 8 pairs
    w_eff = np.concatenate([w_eff, w_eff[:3]])
    kw = dict(W=128, subst=UNIT, go=-2.5, ge=-1.0, with_dirs=with_dirs)
    ref = banded_dp_pallas(*jx(*args), flags=RefFlags(**flags),
                           w_eff=jnp.asarray(w_eff), block_b=8,
                           interpret=True, **kw)
    got = banded_dp_row(*args, flags=ModeFlags(**flags), w_eff=w_eff,
                        device="cpu", **kw)
    assert_same(ref, got, dirs=with_dirs)
    assert got.dirs.shape == ((8, 100, 128) if with_dirs else (0,))


def test_dp_row_band_of_6144_lanes_matches_interpret_kernel(rng):
    """W 6144, a band the card runs as a cluster of blocks, against the
    TPU kernel in interpret mode (8 pairs, one 128-row chunk): every
    lane live on two pairs, dead lanes on the others; scores, end cells
    and the whole direction plane equal."""
    W = 6144
    args, w_eff = mk_row_batch(rng, W=W, L=60)
    args = [np.concatenate([a, a[:3]]) for a in args]
    w_eff = np.concatenate([w_eff, w_eff[:3]])
    kw = dict(W=W, subst=UNIT, go=-2.5, ge=-1.0, with_dirs=True)
    flags = dict(local_start=True, local_end=True)
    ref = banded_dp_pallas(*jx(*args), flags=RefFlags(**flags),
                           w_eff=jnp.asarray(w_eff), block_b=8,
                           interpret=True, **kw)
    got = banded_dp_row(*args, flags=ModeFlags(**flags), w_eff=w_eff,
                        device="cpu", **kw)
    assert_same(ref, got)
    assert float(got.score.max()) > 30


@pytest.mark.parametrize("flags", [dict(), dict(local_end=True)])
def test_dp_row_40_letter_alphabet_matches_lax(rng, flags):
    """A random 40 x 40 matrix (fractional mismatches) against the JAX
    lax engine (the TPU kernel in interpret mode unrolls a 1600-way
    select a cell at A 40 and does not finish in minutes): scores, end
    cells, the direction bytes and the transcripts equal."""
    lanes = [60, 64, 10, 120]
    ss, ts, s_lens, t_lens = mk_edge_batch(rng, lanes, L=90, A=40)
    args = (ss, ts, s_lens, t_lens, np.array(lanes, np.int32) - 127)
    ref, got = lax_and_row(args, flags=flags, with_dirs=True, W=128,
                           subst=random_subst(rng, 40), go=-3.0, ge=-0.5)
    assert_same(ref, got)
    assert_walks_equal(ref, got, args, 128, flags)
    assert float(got.score.max()) > 100


def test_dp_row_widths_the_kernel_refuses(rng):
    """The twin takes any multiple of 128; the kernel's wrapper refuses
    bands above MAX_W before it loads anything, naming the cap and the
    routes that take any W."""
    args, w_eff = mk_row_batch(rng, L=100)
    g = dp_row._prepare(*args, None, W=dp_row.MAX_W + 8192, subst=UNIT,
                        go=-2.0, ge=-1.0, A=None, device=torch.device("cpu"))
    n0 = dp_row.LAUNCHES
    with pytest.raises(ValueError, match="MAX_W = 65536.*native.*"
                       "banded_dp_band_sharded"):
        dp_row._sweep_cuda(g, ModeFlags(), True)
    assert dp_row.LAUNCHES == n0


def lax_and_row(args, *, flags, w_eff=None, **kw):
    ref = banded_dp(*jx(*args), flags=RefFlags(**flags),
                    w_eff=None if w_eff is None else jnp.asarray(w_eff),
                    **kw)
    got = banded_dp_row(*args, flags=ModeFlags(**flags), w_eff=w_eff,
                        device="cpu", **kw)
    return ref, got


def assert_walks_equal(ref, got, args, W, flags):
    ss, ts, _, _, dmin = args
    for b in range(len(ss)):
        if float(got.score[b]) <= -1e29:
            continue
        walk = lambda res, d: traceback_path(
            np.asarray(d), ss[b], ts[b], int(res.end_i[b]),
            int(res.end_j[b]), banded=True, dmax=int(dmin[b]) + W - 1,
            flags=ModeFlags(**flags))
        assert walk(got, got.dirs[b]) == walk(ref, ref.dirs[b]), b


@pytest.mark.parametrize("flags", ROW_FLAGS)
@pytest.mark.parametrize("go", [-2.0, -2.5])
def test_dp_row_matches_lax(rng, flags, go):
    """The flag sets of tests/test_pallas_dp.py on homologous pairs:
    score-only (scores; global end cells, -1 sentinels otherwise) and
    with directions (scores, end cells, bytes, transcripts)."""
    s, t, sl, tl = homologous(rng, 4, 150, 256)
    args = (s, t, sl, tl, np.full((4,), -64, np.int32))
    kw = dict(W=128, subst=UNIT, go=go, ge=-1.0)
    ref, got = lax_and_row(args, flags=flags, with_dirs=True, **kw)
    assert_same(ref, got, dirs=not flags.get("local_start"))
    assert_walks_equal(ref, got, args, 128, flags)
    plain = banded_dp_row(*args, flags=ModeFlags(**flags), device="cpu",
                          **kw)
    np.testing.assert_array_equal(plain.score.numpy(), np.asarray(ref.score))
    if flags.get("local_end") or flags.get("free_end_edges"):
        assert (plain.end_i.numpy() == -1).all()
        assert (plain.end_j.numpy() == -1).all()
    else:
        np.testing.assert_array_equal(plain.end_i.numpy(), sl)
        np.testing.assert_array_equal(plain.end_j.numpy(), tl)
    assert plain.dirs.numel() == 0


def test_dp_row_weff_band_leak(rng):
    """w_eff < W forbids paths through dead lanes: a gap detour around
    the band edge would overscore (-4 against -12 here) if dead lanes
    kept live E values (tests/test_pallas_dp.py::test_pallas_weff_band_leak)."""
    X = rng.integers(0, 4, 20).astype(np.int8)
    Y = rng.integers(0, 4, 20).astype(np.int8)
    Wb = rng.integers(0, 2, 20).astype(np.int8)
    Zb = (2 + rng.integers(0, 2, 20)).astype(np.int8)
    s = np.concatenate([X, Wb, Y])[None]
    t = np.concatenate([X, Zb, Y])[None]
    lens = np.array([60], np.int32)
    args = (s, t, lens, lens, np.array([7 - 127], np.int32))
    subst = np.where(np.eye(4, dtype=bool), 1.0, -10.0).astype(np.float32)
    for flags in ROW_FLAGS[:3]:
        ref, got = lax_and_row(args, flags=flags, w_eff=np.array([8]),
                               W=128, subst=subst, go=-2.0, ge=-1.0,
                               with_dirs=True)
        assert_same(ref, got, dirs=not flags.get("local_start"))


def test_dp_row_ragged_batch(rng):
    """Different lengths and bands per pair, widths up to W = 256
    (tests/test_pallas_dp.py::test_pallas_ragged_batch)."""
    lens = [(100, 90), (50, 70), (128, 128)]
    ss = [rand_seq(A4, a, rng=rng) for a, _ in lens]
    ts = [rand_seq(A4, b, rng=rng) for _, b in lens]
    s_codes, s_lens = pack_sequences(ss, pad_to=128)
    t_codes, t_lens = pack_sequences(ts, pad_to=128)
    args = (s_codes, t_codes, s_lens, t_lens,
            np.array([-100, -120, -60], np.int32))
    subst = np.where(np.eye(4, dtype=bool), 2.0, -3.0).astype(np.float32)
    flags = dict(free_start_edges=True, free_end_edges=True)
    ref, got = lax_and_row(args, flags=flags,
                           w_eff=np.array([150, 200, 256], np.int32), W=256,
                           subst=subst, go=-4.0, ge=-1.0, with_dirs=True)
    assert_same(ref, got)
    assert_walks_equal(ref, got, args, 256, flags)


def test_dp_row_negative_dmax_long_t(rng):
    """A band entirely left of the main diagonal (dmax < 0) over a T
    longer than LS + W: the TPU wrapper's band-frame ring once aliased
    wrapped letters here; the port reads T directly
    (tests/test_pallas_dp.py::test_pallas_negative_dmax_long_t_matches_lax)."""
    B, LS, LT, W = 2, 120, 640, 128
    ss = rng.integers(0, 4, (B, LS)).astype(np.int8)
    ts = rng.integers(0, 4, (B, LT)).astype(np.int8)
    ts[:, 300:300 + LS] = ss
    args = (ss, ts, np.full((B,), LS, np.int32), np.full((B,), LT, np.int32),
            np.full((B,), -420, np.int32))
    for flags in (dict(local_start=True, local_end=True),
                  dict(free_start_edges=True, free_end_edges=True)):
        ref, got = lax_and_row(args, flags=flags, w_eff=np.full((B,), W - 1),
                               W=W, subst=UNIT, go=-2.0, ge=-1.0,
                               with_dirs=True)
        assert_same(ref, got, dirs=not flags.get("local_start"))
        assert float(got.score[0]) > 100   # the planted diagonal was in band


@pytest.mark.parametrize("ge", [-1.0, -0.5])
def test_dp_row_protein_blosum62(rng, ge):
    """A 20-letter alphabet under BLOSUM62 (the general substitution
    path): the JAX kernel's wrapper defaults to A = 4 and its Aligner
    never passes A; the port takes A from the matrix."""
    from biseqt_tpu.matrices import protein_alphabet

    s, t, sl, tl = homologous(rng, 3, 110, 160, protein_alphabet())
    args = (s, t, sl, tl, np.full((3,), -64, np.int32))
    for flags in ROW_FLAGS[:3]:
        ref, got = lax_and_row(args, flags=flags, W=128, subst=BLOSUM62,
                               go=-11.0, ge=ge, with_dirs=True)
        assert_same(ref, got, dirs=not flags.get("local_start"))
        assert_walks_equal(ref, got, args, 128, flags)
        assert float(got.score.max()) > 300


def test_dp_row_rejects_bad_input(rng):
    args, w_eff = mk_row_batch(rng, L=100)
    kw = dict(W=128, subst=UNIT, go=-2.0, ge=-1.0, flags=ModeFlags(),
              w_eff=w_eff, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        banded_dp_row(*args, **dict(kw, W=200))
    with pytest.raises(ValueError, match="nonpositive"):
        banded_dp_row(*args, **dict(kw, go=1.0))
    with pytest.raises(ValueError, match="A = 20"):
        banded_dp_row(*args, A=20, **kw)
    bad = args[0].copy()
    bad[0, 0] = 4
    with pytest.raises(ValueError, match="alphabet"):
        banded_dp_row(bad, *args[1:], **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        banded_dp_row(*args, **dict(kw, device="meta"))


def test_dp_row_never_falls_back_to_cpu(rng):
    """Asked for the card where there is none, the wrapper raises; the
    CPU path never counts a kernel launch."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs it")
    args, w_eff = mk_row_batch(rng, L=100)
    kw = dict(W=128, subst=UNIT, go=-2.0, ge=-1.0, flags=ModeFlags(),
              w_eff=w_eff)
    n0 = dp_row.LAUNCHES
    banded_dp_row(*args, device="cpu", **kw)
    assert dp_row.LAUNCHES == n0
    with pytest.raises((AssertionError, RuntimeError)):
        banded_dp_row(*args, device="cuda", **kw)
