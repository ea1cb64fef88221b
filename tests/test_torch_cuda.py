"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and
skips without one.  The file imports neither jax nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance is exact: the kernels run the plain twins' arithmetic step for
step, so scores, end cells, dirs planes, trace bytes and transcripts
must be equal.  The batch helpers are shared with the CPU parity tests
(tests/test_torch_dp_ad.py, tests/test_torch_walk.py).
"""

import numpy as np
import pytest
import torch

from biseqt_tpu_torch.ops import dp_ad, walk
from biseqt_tpu_torch.ops.banded_dp import ModeFlags
from biseqt_tpu_torch.pipeline import extend_segments
from biseqt_tpu_torch.sequence import Alphabet, Sequence

pytestmark = pytest.mark.cuda

UNIT = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
FLAG_CASES = [
    dict(local_start=True, local_end=True),
    dict(),
    dict(free_start_edges=True, free_end_edges=True),
    dict(free_start_edges=True, local_end=True),
]


def mk_batch(rng):
    """Ragged pairs, mixed dmin parities, per-pair effective widths (the
    batch of tests/test_pallas_dp_ad.py)."""
    B, L = 5, 150
    ss = rng.integers(0, 4, (B, L)).astype(np.int8)
    ts = ss.copy()
    m = rng.random((B, L)) < 0.15
    ts[m] = (ts[m] + 1 + rng.integers(0, 3, m.sum())) % 4
    s_lens = np.array([150, 140, 150, 130, 150], np.int32)
    t_lens = np.array([148, 150, 135, 150, 150], np.int32)
    dmin = np.array([-64, -63, -30, -80, -64], np.int32)
    w_eff = np.array([100, 127, 64, 120, 127], np.int32)
    return (ss, ts, s_lens, t_lens, dmin), w_eff


@pytest.fixture
def rng():
    return np.random.default_rng(0xB15EA7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _assert_results_equal(got, want):
    for a, b in zip(got, want):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("W", [128, 1536])
@pytest.mark.parametrize("flags", FLAG_CASES)
def test_dp_ad_kernel_matches_plain(rng, card, flags, W):
    """Both lane layouts of the kernel (one and two lanes per thread),
    every mode, unit and fractional general scores."""
    args, w_eff = mk_batch(rng)
    args = [torch.as_tensor(x, device=card) for x in args]
    args[4] = args[4] + 128 - W          # keep the band around the diagonal
    general = np.array(
        [[2, -1, -2, -1], [-1, 2, -1, -2], [-2, -1, 2, -1], [-1, -2, -1, 2]],
        np.float32)
    for subst, go, ge in ((UNIT, -2.0, -1.0), (general, -3.0, -0.5)):
        kw = dict(W=W, subst=subst, go=go, ge=ge,
                  flags=ModeFlags(**flags),
                  w_eff=torch.as_tensor(w_eff, device=card), r_chunk=16,
                  device=card)
        for with_dirs in (True, False):
            n0 = dp_ad.LAUNCHES
            got = dp_ad.banded_dp_ad(*args, with_dirs=with_dirs, **kw)
            assert dp_ad.LAUNCHES == n0 + 1
            want = dp_ad.banded_dp_ad_reference(*args, with_dirs=with_dirs,
                                                **kw)
            assert dp_ad.LAUNCHES == n0 + 1
            _assert_results_equal(got, want)
        assert float(got.score.max()) > 60


@pytest.mark.parametrize("B2,Rp,W", [(130, 16, 256), (20, 40, 128)])
def test_walk_kernel_matches_plain(rng, card, B2, Rp, W):
    """Random nibble planes: every source and gap bit pattern, skipped
    pairs, a ragged pair count."""
    B = 2 * B2 - 1
    dirs = rng.integers(0, 256, (Rp, B2, W)).astype(np.uint8)
    dminq = rng.integers(-W + 1, 1, B).astype(np.int32)
    ei = rng.integers(1, Rp, B).astype(np.int32)
    ej = np.clip(ei - dminq - rng.integers(0, W, B), 0, Rp - 1
                 ).astype(np.int32)
    ei[::7] = -1
    on = [torch.as_tensor(x, device=card) for x in (dirs, dminq, ei, ej)]
    n0 = walk.LAUNCHES
    got = walk.traceback_walk(*on, W=W, device=card)
    assert walk.LAUNCHES == n0 + 1
    want = walk.traceback_walk_reference(*on, W=W, device=card)
    _assert_results_equal(got, want)
    assert got[0].any()


def test_extend_segments_card_matches_cpu(rng, card):
    """The whole slice on the card equals the plain twins on the CPU:
    scores, transcripts, start cells and source indices."""
    A4 = Alphabet("ACGT")
    blocks, s_parts, t_parts, segments = 3, [], [], []
    s_pos = t_pos = 0
    for k in range(blocks):
        core = rng.integers(0, 4, 300)
        mut = core.copy()
        hit = rng.random(300) < 0.1
        mut[hit] = (mut[hit] + 1 + rng.integers(0, 3, hit.sum())) % 4
        gap_s, gap_t = 200 + 50 * k, 100 + 300 * k
        s_parts += [rng.integers(0, 4, gap_s), core]
        t_parts += [rng.integers(0, 4, gap_t), mut]
        i0, j0 = s_pos + gap_s, t_pos + gap_t
        d, a = i0 - j0, i0 + j0
        segments.append({"segment": ((d - 8, d + 8), (a, a + 600))})
        s_pos, t_pos = i0 + 300, j0 + 300
    S = Sequence(A4, np.concatenate(s_parts))
    T = Sequence(A4, np.concatenate(t_parts))
    kw = dict(go_score=-3.0, ge_score=-1.0, with_transcripts=True,
              _r_chunk=16)
    n_dp, n_walk = dp_ad.LAUNCHES, walk.LAUNCHES
    got = extend_segments(S, T, segments, device=card, **kw)
    assert dp_ad.LAUNCHES > n_dp and walk.LAUNCHES > n_walk
    want = extend_segments(S, T, segments, device="cpu", **kw)
    assert got == want
    assert all(seg["score"] > 150 and len(seg["transcript"]) > 250
               for seg in got)


def test_kernel_wrappers_refuse_bad_launches(card):
    """Shapes the kernels do not take raise before any launch."""
    x = torch.zeros((2, 8), dtype=torch.int8, device=card)
    lens = torch.full((2,), 8, dtype=torch.int32, device=card)
    kw = dict(subst=UNIT, go=-2.0, ge=-1.0, flags=ModeFlags(), device=card)
    n0 = dp_ad.LAUNCHES
    with pytest.raises(ValueError, match="W must be even"):
        dp_ad.banded_dp_ad(x, x, lens, lens, lens * 0, W=4096, **kw)
    with pytest.raises(ValueError, match="passed with device"):
        dp_ad.banded_dp_ad(x.cpu(), x, lens, lens, lens * 0, W=128, **kw)
    with pytest.raises(ValueError, match="dirs must be uint8"):
        walk.traceback_walk(torch.zeros((4, 1, 128), device=card), lens,
                            lens, lens, W=128, device=card)
    assert dp_ad.LAUNCHES == n0
