"""Stochastic models: random sequences, mutation processes, null-model math.

The port of :mod:`biseqt_tpu.stochastics` (the reference's
``biseqt/stochastics.py — rand_seq, MutationProcess,
binomial_to_normal, normal_neg_log_pvalue``), in two parts:

* the host tier, a copy of the JAX package's numpy simulation
  (:func:`rand_seq`, :func:`rand_read`, :class:`MutationProcess`):
  with the same ``np.random.Generator`` it gives the same sequences
  and transcripts, letter for letter;
* the null-model math (:func:`binomial_to_normal`,
  :func:`np_log_erfc`, :func:`normal_neg_log_pvalue`) in float32
  PyTorch on ``device`` (the card by default).  Word-Blot's statistics
  (:mod:`.ops.blot_stats`) call it.

The JAX package's device tier (``rand_seq_batch``, ``mutate_batch``) is
not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops.banded_dp import on_device, resolve_device
from .sequence import Alphabet, EditTranscript, Sequence

__all__ = [
    "rand_seq",
    "rand_read",
    "MutationProcess",
    "binomial_to_normal",
    "normal_neg_log_pvalue",
    "np_log_erfc",
]


def _generator(rng) -> np.random.Generator:
    return rng if isinstance(rng, np.random.Generator) \
        else np.random.default_rng(rng)


# ---------------------------------------------------------------------------
# Host-tier simulation (object API, mirrors the reference contract)
# ---------------------------------------------------------------------------

def rand_seq(alphabet: Alphabet, size: int, p=None, rng=None) -> Sequence:
    """A random sequence of the given length over ``alphabet``, letters
    drawn iid with probabilities ``p`` (uniform by default)."""
    contents = _generator(rng).choice(len(alphabet), size=int(size), p=p)
    return Sequence(alphabet, contents)


def rand_read(seq: Sequence, len_mean, len_sd=1.0, num=1, rng=None):
    """Lazy random reads (substrings) of ``seq``: lengths ~ Normal(len_mean,
    len_sd) clamped to [1, len(seq)], starts uniform.  Yields
    ``(read, start_pos)``.  Error-free; compose with
    :meth:`MutationProcess.mutate` for noisy reads."""
    rng = _generator(rng)
    n = len(seq)
    for _ in range(int(num)):
        L = int(round(rng.normal(len_mean, len_sd)))
        L = max(1, min(n, L))
        start = int(rng.integers(0, n - L + 1))
        yield seq[start : start + L], start


class MutationProcess:
    """A per-letter substitution + affine-indel mutation model.

    * ``subst_probs``: either a full |Σ|×|Σ| matrix of P(b|a) or a scalar
      uniform error rate (diagonal = 1-p, off-diagonals = p/(|Σ|-1)).
    * ``go_prob``/``ge_prob``: gap-open and gap-extend probabilities of the
      affine indel model (insertions and deletions equally likely).
    * :meth:`mutate` returns the mutant plus the MSID edit transcript, the
      alphabet the aligner emits, so simulation is its own test oracle.
    * :meth:`log_odds_scores` turns the same probabilities into aligner
      scores.
    """

    def __init__(self, alphabet, subst_probs=None, ge_prob=0.0, go_prob=0.0,
                 insert_dist=None, rng=None):
        assert isinstance(alphabet, Alphabet)
        self.alphabet = alphabet
        n = len(alphabet)
        if subst_probs is None:
            subst_probs = 0.0
        if np.isscalar(subst_probs):
            p = float(subst_probs)
            m = np.full((n, n), p / max(n - 1, 1))
            np.fill_diagonal(m, 1.0 - p)
            self.subst_probs = m
        else:
            self.subst_probs = np.asarray(subst_probs, dtype=np.float64)
            assert self.subst_probs.shape == (n, n)
            assert np.allclose(self.subst_probs.sum(axis=1), 1.0, atol=1e-8)
        assert 0 <= ge_prob < 1 and 0 <= go_prob < 1
        self.go_prob = float(go_prob)
        self.ge_prob = float(ge_prob)
        # distribution over inserted letters (uniform default)
        if insert_dist is None:
            insert_dist = np.full((n,), 1.0 / n)
        self.insert_dist = np.asarray(insert_dist, dtype=np.float64)
        self._rng = _generator(rng)

    # -- simulation -----------------------------------------------------------
    def mutate(self, seq: Sequence, rng=None):
        """Mutate ``seq``; returns ``(mutant, EditTranscript)``.

        At each position: with prob ``go_prob`` open a gap (insertion or
        deletion with equal probability), extending with prob ``ge_prob``;
        otherwise copy the letter through the substitution channel.
        """
        rng = self._rng if rng is None else _generator(rng)
        n = len(self.alphabet)
        out = []
        ops = []
        i = 0
        L = len(seq)
        contents = seq.contents
        while i < L:
            if self.go_prob and rng.random() < self.go_prob:
                if rng.random() < 0.5:
                    # an insertion run; the origin letter is still due
                    ops.append("I")
                    out.append(int(rng.choice(n, p=self.insert_dist)))
                    while rng.random() < self.ge_prob:
                        ops.append("I")
                        out.append(int(rng.choice(n, p=self.insert_dist)))
                    continue
                # a deletion run
                ops.append("D")
                i += 1
                while i < L and rng.random() < self.ge_prob:
                    ops.append("D")
                    i += 1
                continue
            a = contents[i]
            b = int(rng.choice(n, p=self.subst_probs[a]))
            out.append(b)
            ops.append("M" if a == b else "S")
            i += 1
        return Sequence(self.alphabet, out), EditTranscript("".join(ops))

    def noisy_read(self, seq: Sequence, len_mean, len_sd=1.0, rng=None):
        """A single noisy read: a substring, mutated.  Returns ``(read,
        start_pos, transcript)``."""
        rng = self._rng if rng is None else _generator(rng)
        (clean, start), = list(rand_read(seq, len_mean, len_sd, num=1,
                                         rng=rng))
        read, tx = self.mutate(clean, rng=rng)
        return read, start, tx

    # -- score derivation -----------------------------------------------------
    def log_odds_scores(self, null_process=None):
        """``(subst_scores, go_score, ge_score)`` by log-odds:
        S[a][b] = log(P(b|a) / P0(b|a)) against a null process (uniform
        letters by default), ``go_score = log(go_prob)``,
        ``ge_score = log(ge_prob)``."""
        n = len(self.alphabet)
        if null_process is None:
            null = np.full((n, n), 1.0 / n)
        else:
            null = np.asarray(null_process.subst_probs)
        with np.errstate(divide="ignore"):
            subst = np.log(self.subst_probs) - np.log(null)
        go = np.log(self.go_prob) if self.go_prob > 0 else -np.inf
        ge = np.log(self.ge_prob) if self.ge_prob > 0 else -np.inf
        return subst.tolist(), float(go), float(ge)


# ---------------------------------------------------------------------------
# Null-model math (normal approximations, stable log p-values), float32
# ---------------------------------------------------------------------------

def _f32(x, device) -> torch.Tensor:
    return on_device(x, torch.float32, device)


def binomial_to_normal(n, p, *, device="cuda"):
    """Mean and standard deviation of the normal approximating
    Binomial(n, p), in float32 on ``device``."""
    device = resolve_device(device)
    n, p = _f32(n, device), _f32(p, device)
    return n * p, torch.sqrt(n * p * (1.0 - p))


def np_log_erfc(z, *, device="cuda"):
    """Numerically stable ``log(erfc(z))`` for large positive z: the direct
    formula for z <= 3, beyond it the asymptotic expansion
    ``erfc(z) ~ exp(-z^2) / (z sqrt(pi)) (1 - 1/(2 z^2))``."""
    z = _f32(z, resolve_device(device))
    direct = torch.log(torch.special.erfc(torch.clamp(z, max=3.0)))
    z_safe = torch.clamp(z, min=3.0)
    half_log_pi = 0.5 * torch.log(torch.tensor(math.pi, dtype=torch.float32))
    asym = (-z_safe * z_safe - torch.log(z_safe) - half_log_pi.to(z.device)
            + torch.log1p(-1.0 / (2.0 * z_safe * z_safe)))
    return torch.where(z <= 3.0, direct, asym)


def normal_neg_log_pvalue(mu, sd, x, *, device="cuda"):
    """−log of the upper-tail p-value of Normal(mu, sd) at x, stably:
    ``-log P(X >= x)``; large values mean x is far in the upper tail.
    Vectorized; for sd == 0 it is +inf where x > mu and 0 elsewhere."""
    device = resolve_device(device)
    mu, sd, x = _f32(mu, device), _f32(sd, device), _f32(x, device)
    z = (x - mu) / torch.where(sd > 0, sd, torch.ones_like(sd))
    z = z / torch.sqrt(torch.tensor(2.0, device=device))
    # P(X >= x) = erfc(z) / 2
    log2 = torch.log(torch.tensor(2.0, device=device))
    out = -(np_log_erfc(z, device=device) - log2)
    return torch.where(sd > 0, out, torch.where(
        x > mu, torch.tensor(math.inf, device=device),
        torch.tensor(0.0, device=device)))
