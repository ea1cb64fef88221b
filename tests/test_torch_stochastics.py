"""The port's stochastics (biseqt_tpu_torch.stochastics) against the JAX
package's, on the same inputs.

The host tier (random sequences, reads, the mutation process) is held
bit for bit: with the same numpy generator both give the same letters
and transcripts.  The float32 null-model math is held to rtol 1e-5,
atol 1e-6 over grids that cross the asymptotic switch at z = 3, the
sd == 0 branch and x on both sides of mu; each case prints its largest
|d|.
"""

import numpy as np
import pytest
import torch

from biseqt_tpu import stochastics as ref
from biseqt_tpu.sequence import Alphabet
from biseqt_tpu_torch import stochastics as port
from biseqt_tpu_torch.sequence import from_reference

RTOL, ATOL = 1e-5, 1e-6
A4 = Alphabet("ACGT")
A20 = Alphabet("ACDEFGHIKLMNPQRSTVWY")


def _close(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = np.isfinite(want)
    d = np.abs(got[finite] - want[finite])
    print("%s: max |d| %.3g over %d values" % (what, d.max(initial=0.0),
                                              want.size))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("alphabet,size,p", [
    (A4, 1000, None), (A4, 1, None), (A4, 500, [0.1, 0.2, 0.3, 0.4]),
    (A20, 300, None)])
def test_rand_seq_bit_equal(alphabet, size, p):
    want = ref.rand_seq(alphabet, size, p=p, rng=np.random.default_rng(7))
    got = port.rand_seq(from_reference(alphabet), size, p=p,
                        rng=np.random.default_rng(7))
    assert np.array_equal(got.to_array(), want.to_array())
    assert got.content_id == want.content_id


def test_rand_read_bit_equal():
    seq = ref.rand_seq(A4, 2000, rng=np.random.default_rng(1))
    want = list(ref.rand_read(seq, 150, 30, num=20,
                              rng=np.random.default_rng(2)))
    got = list(port.rand_read(from_reference(seq), 150, 30, num=20,
                              rng=np.random.default_rng(2)))
    assert [(r.to_array().tolist(), s) for r, s in got] == \
        [(r.to_array().tolist(), s) for r, s in want]


@pytest.mark.parametrize("subst,go,ge", [
    (0.1, 0.0, 0.0), (0.08, 0.03, 0.1), (0.2, 0.1, 0.5), ("matrix", 0.05,
                                                          0.2)])
def test_mutate_bit_equal(subst, go, ge):
    if subst == "matrix":
        subst = np.random.default_rng(3).dirichlet(np.ones(4), size=4)
    seq = ref.rand_seq(A4, 3000, rng=np.random.default_rng(4))
    M_ref = ref.MutationProcess(A4, subst_probs=subst, go_prob=go,
                                ge_prob=ge, rng=np.random.default_rng(5))
    M_port = port.MutationProcess(from_reference(A4), subst_probs=subst,
                                  go_prob=go, ge_prob=ge,
                                  rng=np.random.default_rng(5))
    for _ in range(2):        # the process's own generator advances alike
        (mut_r, tx_r), (mut_p, tx_p) = (M_ref.mutate(seq),
                                        M_port.mutate(from_reference(seq)))
        assert np.array_equal(mut_p.to_array(), mut_r.to_array())
        assert str(tx_p) == str(tx_r)
        assert tx_p.origin_len == len(seq) and tx_p.mutate_len == len(mut_p)
    read_r = M_ref.noisy_read(seq, 200, 20, rng=np.random.default_rng(6))
    read_p = M_port.noisy_read(from_reference(seq), 200, 20,
                               rng=np.random.default_rng(6))
    assert np.array_equal(read_p[0].to_array(), read_r[0].to_array())
    assert read_p[1:] == read_r[1:]
    assert M_port.log_odds_scores() == M_ref.log_odds_scores()
    null_r = ref.MutationProcess(A4, subst_probs=0.3)
    null_p = port.MutationProcess(from_reference(A4), subst_probs=0.3)
    assert M_port.log_odds_scores(null_p) == M_ref.log_odds_scores(null_r)


def test_binomial_to_normal_matches():
    n = np.asarray([0, 1, 10, 1000, 9600, 1e7], np.float32)
    p = np.asarray([0.0, 0.5, 2.0 ** -24, 0.6 ** 12, 0.25, 1.0], np.float32)
    mu_r, sd_r = ref.binomial_to_normal(n, p)
    mu_p, sd_p = port.binomial_to_normal(n, p, device="cpu")
    _close(mu_p, mu_r, "binomial mu")
    _close(sd_p, sd_r, "binomial sd")
    mu_p, sd_p = port.binomial_to_normal(torch.as_tensor(n), 0.3,
                                          device="cpu")
    mu_r, sd_r = ref.binomial_to_normal(n, 0.3)
    _close(mu_p, mu_r, "binomial mu, scalar p")
    _close(sd_p, sd_r, "binomial sd, scalar p")


def test_np_log_erfc_matches_across_the_switch():
    z = np.concatenate([np.linspace(-6, 6, 241), [2.999, 3.0, 3.001],
                        np.linspace(3, 60, 115)]).astype(np.float32)
    got = port.np_log_erfc(z, device="cpu")
    assert got.dtype == torch.float32
    _close(got, ref.np_log_erfc(z), "log erfc")


def test_normal_neg_log_pvalue_matches():
    mu, sd, x = np.meshgrid(np.asarray([0.0, 2.5, 40.0], np.float32),
                            np.asarray([0.0, 1.0, 3.7], np.float32),
                            np.asarray([-10, 0, 2.5, 3, 7, 40, 41, 500],
                                       np.float32), indexing="ij")
    mu, sd, x = (v.ravel() for v in (mu, sd, x))
    want = np.asarray(ref.normal_neg_log_pvalue(mu, sd, x))
    got = port.normal_neg_log_pvalue(mu, sd, x, device="cpu")
    # sd == 0: +inf above mu, 0 at or below it
    zero = sd == 0
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    assert np.isinf(want[zero & (x > mu)]).all()
    assert (want[zero & (x <= mu)] == 0).all()
    _close(got, want, "neg log p-value")
