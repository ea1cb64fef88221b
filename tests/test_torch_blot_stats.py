"""The port's Word-Blot statistics (biseqt_tpu_torch.ops.blot_stats)
against the JAX package's, on the same seeded inputs, on the CPU.

Integer grids and band sums are held exactly; the float32 statistics
(p̂, S0, S1) to rtol 1e-5, atol 1e-6, printing the largest |d|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biseqt_tpu.ops import blot_stats as ref
from biseqt_tpu_torch.ops import blot_stats as port

RTOL, ATOL = 1e-5, 1e-6
CPU = dict(device="cpu")


def _close(got, want, what):
    got = np.asarray(got.cpu().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)[np.isfinite(want)]
    print("%s: max |d| %.3g over %d values" % (what, d.max(initial=0.0),
                                              want.size))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,nd,na", [(0, 4, 5), (500, 13, 7), (4000, 64, 64)])
def test_grid_counts_match(n, nd, na):
    rng = np.random.default_rng(n)
    # coordinates a little past the grid on both sides: they clip
    d = rng.integers(-2, nd + 2, n).astype(np.int32)
    a = rng.integers(-2, na + 2, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    want = np.asarray(ref.grid_counts(jnp.asarray(d), jnp.asarray(a),
                                      jnp.asarray(valid), nd, na))
    # the port takes the seeds alone: the JAX package's valid slots
    got = port.grid_counts(d[valid], a[valid], nd, na, **CPU)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == int(valid.sum())


@pytest.mark.parametrize("shape", [(1, 1), (3, 8), (40, 17)])
def test_box_sum3_matches(shape):
    grid = np.random.default_rng(sum(shape)).integers(0, 9, shape
                                                       ).astype(np.int32)
    want = np.asarray(ref.box_sum3(jnp.asarray(grid)))
    assert np.array_equal(port.box_sum3(grid, **CPU).numpy(), want)


@pytest.mark.parametrize("radius", [0, 1, 5, 40, 500])
def test_sliding_band_sums_match(radius):
    counts = np.random.default_rng(radius).integers(0, 30, 301
                                                     ).astype(np.int32)
    want = np.asarray(ref.sliding_band_sums(jnp.asarray(counts),
                                            jnp.int32(radius)))
    got = port.sliding_band_sums(counts, radius, **CPU)
    assert np.array_equal(got.numpy(), want)


def _stats_inputs():
    rng = np.random.default_rng(12)
    n = np.concatenate([[0, 1, 5, 50, 118], rng.integers(0, 3000, 60)])
    seglen = np.concatenate([[1, 100, 100, 100, 900],
                             rng.integers(1, 200000, 60)]).astype(np.float64)
    area = seglen * np.concatenate([[1, 20, 20, 2000, 45],
                                    rng.integers(1, 700, 60)])
    return n.astype(np.float32), area, seglen


@pytest.mark.parametrize("wordlen,A", [(8, 4), (12, 4), (5, 20)])
def test_h0_h1_scores_and_p_hat_match(wordlen, A):
    n, area, seglen = _stats_inputs()
    want_p = np.asarray(ref.estimate_match_probability(n, seglen, wordlen))
    got_p = port.estimate_match_probability(n, seglen, wordlen, **CPU)
    _close(got_p, want_p, "p-hat")
    for p_match in (want_p, 0.9, np.maximum(want_p, 1e-3)):
        want = ref.h0_h1_scores(n, area, seglen, p_match, wordlen, A)
        got = port.h0_h1_scores(n, area, seglen, p_match, wordlen, A, **CPU)
        _close(got[0], np.asarray(want[0]), "S0")
        _close(got[1], np.asarray(want[1]), "S1")


def test_integer_pow_is_xlas_product():
    """p ** w by binary exponentiation equals jnp's ``x ** int`` bit for
    bit on float32, where no product is subnormal (XLA on the CPU
    flushes those to zero)."""
    x = np.random.default_rng(0).uniform(0.01, 1.0, 10000).astype(
        np.float32)
    for w in (1, 2, 7, 8, 12, 15):
        want = np.asarray(jnp.asarray(x) ** w)
        got = port._integer_pow(torch.as_tensor(x), w).numpy()
        assert np.array_equal(got, want), w
