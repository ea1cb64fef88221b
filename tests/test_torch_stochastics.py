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


# ---------------------------------------------------------------------------
# the batch tier: the materialisation on the JAX package's draws, exactly;
# the port's own draws against the model's rates
# ---------------------------------------------------------------------------

def _jax_draws(key, B, L, subst_prob, go, ge, alphabet_len=4):
    """The draws ``biseqt_tpu.stochastics.mutate_batch`` makes from
    ``key``: the same split keys, calls and shapes."""
    import jax
    import jax.numpy as jnp

    cap = port.batch_capacity(L)
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    half_go = float(go) / 2.0
    del_rate = min(half_go / max(1.0 - float(ge), 1e-6), 0.49)
    uniform = lambda k: np.asarray(jax.random.uniform(k, (B, L)))
    return {
        "err": uniform(k1) < subst_prob,
        "shift": np.asarray(jax.random.randint(k2, (B, L), 1,
                                               alphabet_len)),
        "deleted": uniform(k3) < del_rate,
        "ins_open": uniform(k4) < half_go,
        "u": np.asarray(jax.random.uniform(k5, (B, L), minval=1e-7,
                                           maxval=1.0)),
        "ins_codes": np.asarray(jax.random.randint(
            k6, (B, cap), 0, alphabet_len, dtype=jnp.int32)),
    }


@pytest.mark.parametrize("subst,go,ge,max_ins_run,alphabet_len", [
    (0.2, 0.1, 0.2, 8, 4), (0.0, 0.0, 0.0, 8, 4),
    (0.072, 0.024, 0.06, 8, 4), (0.1, 0.3, 0.7, 3, 4),
    (0.25, 0.05, 0.3, 8, 20), (0.1, 0.9, 0.0, 8, 4)])
def test_mutate_batch_materialisation_equals_jax(subst, go, ge, max_ins_run,
                                                 alphabet_len):
    """Given the JAX package's draws, the port's materialisation gives
    ``biseqt_tpu.stochastics.mutate_batch``'s codes and lengths exactly
    (ragged rows with PAD tails in the input)."""
    import jax
    import jax.numpy as jnp

    B, L = 16, 1500
    codes = np.array(ref.rand_seq_batch(jax.random.PRNGKey(0), B, L,
                                        alphabet_len))
    lens = np.random.default_rng(1).integers(L // 2, L + 1, B).astype(
        np.int32)
    lens[0] = L
    codes[np.arange(L)[None, :] >= lens[:, None]] = -1
    key = jax.random.PRNGKey(5)
    want_codes, want_lens = ref.mutate_batch(
        key, jnp.asarray(codes), jnp.asarray(lens), subst, go, ge,
        alphabet_len=alphabet_len, max_ins_run=max_ins_run)
    got_codes, got_lens = port.apply_batch_mutations(
        codes, lens, _jax_draws(key, B, L, subst, go, ge, alphabet_len), ge,
        alphabet_len, max_ins_run, device="cpu")
    assert got_codes.dtype == torch.int8 and got_lens.dtype == torch.int32
    assert np.array_equal(got_codes.numpy(), np.asarray(want_codes))
    assert np.array_equal(got_lens.numpy(), np.asarray(want_lens))


def _within_3_sigma(hits, n, p, what):
    sigma = np.sqrt(n * p * (1 - p))
    print("%s: %d of %d, expected %.1f +- %.1f" % (what, hits, n, n * p,
                                                  sigma))
    assert abs(hits - n * p) <= 3 * sigma, what


def test_device_tier_batch_sim_on_the_ports_draws():
    """``tests/test_stochastics.py``'s batch-tier case through the port:
    uniform letters, lengths near L, exact PAD tails, mutations present,
    the identity at zero rates."""
    B, L = 16, 2000
    gen = torch.Generator().manual_seed(0)
    codes = port.rand_seq_batch(gen, B, L, device="cpu")
    assert codes.dtype == torch.int8 and codes.shape == (B, L)
    counts = np.bincount(codes.numpy().ravel() % 4, minlength=4)
    assert counts.min() > B * L / 4 * 0.9
    lengths = torch.full((B,), L, dtype=torch.int32)
    mut, mlen = port.mutate_batch(gen, codes, lengths, subst_prob=0.2,
                                  go_prob=0.1, ge_prob=0.2, device="cpu")
    mut_np, mlen_np = mut.numpy(), mlen.numpy()
    assert mut.shape == (B, port.batch_capacity(L))
    assert (np.abs(mlen_np - L) < 0.2 * L).all()
    for b in range(B):
        assert (mut_np[b, mlen_np[b]:] == -1).all()
        assert (mut_np[b, :mlen_np[b]] >= 0).all()
    assert (codes.numpy() == mut_np[:, :L]).mean() < 0.9
    mut0, mlen0 = port.mutate_batch(gen, codes, lengths, 0.0, 0.0, 0.0,
                                    device="cpu")
    assert (mlen0.numpy() == L).all()
    assert (mut0.numpy()[:, :L] == codes.numpy()).all()
    assert (mut0.numpy()[:, L:] == -1).all()


def test_batch_tier_marginals_within_three_sigma():
    """The port's draws against the model's rates: substitutions (seen in
    the mutant, no indels), deletions at ``(go/2)/(1-ge)``, insertion
    opens at go/2, and letters at ``p``, each within 3 sigma."""
    B, L = 32, 4000
    gen = torch.Generator().manual_seed(11)
    codes = port.rand_seq_batch(gen, B, L, device="cpu")
    lengths = torch.full((B,), L, dtype=torch.int32)
    mut, _ = port.mutate_batch(gen, codes, lengths, 0.15, 0.0, 0.0,
                               device="cpu")
    diff = int((mut[:, :L] != codes).sum())
    _within_3_sigma(diff, B * L, 0.15, "substitutions")
    go, ge = 0.05, 0.3
    draws = port.batch_mutation_draws(gen, B, L, 0.0, go, ge, device="cpu")
    _within_3_sigma(int(draws["deleted"].sum()), B * L,
                    (go / 2) / (1 - ge), "deletions")
    _within_3_sigma(int(draws["ins_open"].sum()), B * L, go / 2,
                    "insertion opens")
    assert draws["u"].min() >= 1e-7 and draws["u"].max() < 1.0
    p = [0.1, 0.2, 0.3, 0.4]
    biased = port.rand_seq_batch(gen, 8, 5000, p=p, device="cpu")
    for letter, q in enumerate(p):
        _within_3_sigma(int((biased == letter).sum()), 8 * 5000, q,
                        "letter %d" % letter)


def test_batch_tier_one_seed_one_output():
    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        codes = port.rand_seq_batch(gen, 4, 300, device="cpu")
        return port.mutate_batch(gen, codes, np.full(4, 300, np.int32), 0.1,
                                 0.05, 0.2, device="cpu")
    (a, la), (b, lb), (c, _) = run(7), run(7), run(8)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c)


def test_batch_tier_generator_must_live_on_the_outputs_device():
    gen = torch.Generator()
    with pytest.raises(ValueError, match="generator"):
        port._check_generator(gen, torch.device("cuda", 0))
    port._check_generator(gen, torch.device("cpu"))
