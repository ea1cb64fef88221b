"""Pure-Python models of the integer bookkeeping of the CUDA kernel K1
(``biseqt_tpu_torch/csrc/dp_ad.cu``), held to the formulas of its plain
twin (``ops/dp_ad.py``).

The kernel runs every float operation of the twin in the twin's order;
what it does differently is integer work: the drift's chunk index and
in-chunk step are counters, each lane's sequence positions are counters
that advance once per pair of steps, the pair a lane holds is fixed per
half of a pair of steps, and the free-start rays and the end trackers
are tested on the lane's own cell.  These tests replay that bookkeeping
on the CPU (the kernel itself runs only on the card) and require it to
give the twin's values exactly, for every step and lane.
"""

import numpy as np
import pytest

from biseqt_tpu_torch.ops.dp_ad import _ga


def ga_counters(g, Apad):
    """The kernel's drifted zero of steps 0 .. Apad - 1: ``ga0 +
    f32(gd * r)`` with r counting up by two per pair of steps and
    wrapping at R, and ``ga0 = f32(cq) * rgd`` renewed at each wrap."""
    R, gd, rgd = g["R"], g["gd"], g["rgd"]
    out = []
    cq, r, ga0 = 0, 0, np.float32(0.0)
    for _ in range(0, Apad, 2):
        for rr in (r, r + 1):
            out.append(np.float32(ga0 + np.float32(gd * float(rr))))
        r += 2
        if r == R:
            r, cq = 0, cq + 1
            ga0 = np.float32(np.float32(cq) * rgd) if gd != 0.0 \
                else np.float32(0.0)
    return np.array(out, np.float32)


@pytest.mark.parametrize("gd", [0.0, 1.0, 0.5])
@pytest.mark.parametrize("R", [16, 128])
def test_ga_counters_equal_chunked_ga(R, gd):
    """The counters give ``_ga(a, g)`` bit for bit at every step of a
    smoke-sized launch (Apad 24704)."""
    g = dict(R=R, gd=gd, rgd=np.float32(R * gd))
    Apad = 24704
    got = ga_counters(g, Apad)
    want = np.array([_ga(a, g) for a in range(Apad)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _u32(x):
    return np.asarray(x, np.int64) & 0xFFFFFFFF


def _lane_model(W, lpt, dq, sl, tl, Apad):
    """Replays the kernel's per-lane bookkeeping for every step a and lane
    k of one plane row (pairs 0 and 1) and checks it against the twin's
    formulas."""
    nt = W // lpt
    odd = nt % 2
    a = np.arange(Apad, dtype=np.int32)[:, None]
    k = np.arange(W, dtype=np.int32)[None, :]
    tid, m = k % nt, k // nt
    h, c = a % 2, a // 2
    # the twin: lane k holds pair (a + k) % 2 at step a
    p = (a + k) % 2
    dqp, slp, tlp = dq[p], sl[p], tl[p]
    i = (a + dqp + k) // 2
    j = (a - dqp - k) // 2
    # the kernel: per lane and half, SI / TJ set up once, plus c
    SI = ((h + dqp + k) >> 1) - 1
    TJ = ((h - dqp - k) >> 1) - 1
    si, tj = c + SI, c + TJ
    assert np.array_equal(si, i - 1) and np.array_equal(tj, j - 1)
    # SI / TJ depend on the half alone, not on the step
    assert np.array_equal(np.tile(SI[:2], (Apad // 2, 1)), SI)
    # lane m of a thread holds in half h the pair that lane 0 of the
    # thread holds in half hh (thread constants indexed by hh)
    hh = np.where(odd & (m % 2 == 1), h ^ 1, h)
    assert np.array_equal((hh + tid) % 2, p)
    # the code loads: (unsigned) si < sl against 1 <= i <= sl
    assert np.array_equal(_u32(si) < slp, (i >= 1) & (i - 1 < slp))
    assert np.array_equal(_u32(tj) < tlp, (j >= 1) & (j - 1 < tlp))
    # free-start rays: the twin tests both pairs' rays on every lane
    ray = ((k == -dq[0] - a) | (k == a - dq[0])
           | (k == -dq[1] - a) | (k == a - dq[1]))
    assert np.array_equal(ray, (si == -1) | (tj == -1))
    # free-end trackers
    sltl = sl + tl
    rays = np.zeros_like(ray)
    for q in (0, 1):
        rays |= ((k == 2 * sl[q] - dq[q] - a) & (a >= sl[q])
                 & (a <= sltl[q]))
        rays |= ((k == a - dq[q] - 2 * tl[q]) & (a >= tl[q])
                 & (a <= sltl[q]))
    got = (((si == slp - 1) & (_u32(tj + 1) <= tlp))
           | ((tj == tlp - 1) & (_u32(si + 1) <= slp)))
    assert np.array_equal(rays, got)
    # the global end cell
    end = np.zeros_like(ray)
    for q in (0, 1):
        end |= (a == sltl[q]) & (k == sl[q] - tl[q] - dq[q])
    assert np.array_equal(end, (si == slp - 1) & (tj == tlp - 1))
    return int(rays.sum()), int(end.sum()), int(ray.sum())


@pytest.mark.parametrize("W,lpt", [(128, 1), (256, 1), (1026, 2),
                                   (1536, 2), (2052, 4), (4096, 4)])
def test_lane_bookkeeping_equals_twin(W, lpt):
    """Every lane layout (one, two and four lanes per thread, even and
    odd thread counts), bands that hold the whole matrix, bands left and
    right of the main diagonal, and empty sequences."""
    rng = np.random.default_rng(W)
    hit = np.zeros(3, np.int64)
    for n in range(6):
        sl = rng.integers(0, 200, 2).astype(np.int32)
        tl = rng.integers(0, 200, 2).astype(np.int32)
        sl[n % 2] *= n != 3                 # an empty s in one case
        # parity-adjusted band starts: dq0 even, dq1 odd
        d0 = int(rng.integers(-min(W, 400), 50))
        dq0 = d0 - d0 % 2
        dq = np.array([dq0, dq0 + 2 * int(rng.integers(-3, 4)) + 1],
                      np.int32)
        Apad = int(sl.max() + tl.max() + 2 + 15) // 16 * 16
        hit += _lane_model(W, lpt, dq, sl, tl, Apad)
    assert hit.all()         # the free-end, end-cell and ray tests fired
