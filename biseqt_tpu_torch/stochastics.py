"""Stochastic models: random sequences, mutation processes, null-model math.

The port of :mod:`biseqt_tpu.stochastics` (the reference's
``biseqt/stochastics.py — rand_seq, MutationProcess,
binomial_to_normal, normal_neg_log_pvalue``), in three parts:

* the host tier, a copy of the JAX package's numpy simulation
  (:func:`rand_seq`, :func:`rand_read`, :class:`MutationProcess`):
  with the same ``np.random.Generator`` it gives the same sequences
  and transcripts, letter for letter;
* the null-model math (:func:`binomial_to_normal`,
  :func:`np_log_erfc`, :func:`normal_neg_log_pvalue`) in float32
  PyTorch on ``device`` (the card by default).  Word-Blot's statistics
  (:mod:`.ops.blot_stats`) call it;
* the batch tier (:func:`rand_seq_batch`, :func:`mutate_batch`), which
  makes large packed workloads on ``device`` from a ``torch.Generator``.
  Its random draws cannot equal ``jax.random``'s, so
  :func:`mutate_batch` is split into the draws
  (:func:`batch_mutation_draws`) and a deterministic materialisation
  (:func:`apply_batch_mutations`): given the JAX package's draws, the
  materialisation gives its codes and lengths exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops.banded_dp import on_device, resolve_device
from .sequence import PAD, Alphabet, EditTranscript, Sequence

__all__ = [
    "rand_seq",
    "rand_read",
    "MutationProcess",
    "binomial_to_normal",
    "normal_neg_log_pvalue",
    "np_log_erfc",
    "rand_seq_batch",
    "mutate_batch",
    "batch_mutation_draws",
    "apply_batch_mutations",
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


# ---------------------------------------------------------------------------
# Batch tier (packed [B, L] workloads on the device)
# ---------------------------------------------------------------------------

def _check_generator(generator: torch.Generator, device: torch.device):
    gen = generator.device
    if gen.type != device.type or (
            device.type == "cuda" and (gen.index or 0) != device.index):
        raise ValueError("the generator lives on %s, the output on %s"
                         % (gen, device))


def rand_seq_batch(generator, batch, length, alphabet_len=4, p=None, *,
                   device="cuda"):
    """A batch of random code rows, int8 ``[batch, length]`` on
    ``device``, letters iid uniform or with probabilities ``p``.
    ``generator`` is a ``torch.Generator`` on ``device``."""
    device = resolve_device(device)
    _check_generator(generator, device)
    if p is None:
        return torch.randint(0, alphabet_len, (batch, length),
                             generator=generator, device=device,
                             dtype=torch.int8)
    probs = torch.as_tensor(np.asarray(p, np.float64), device=device)
    draws = torch.multinomial(probs, batch * length, replacement=True,
                              generator=generator)
    return draws.reshape(batch, length).to(torch.int8)


def batch_capacity(length: int) -> int:
    """The output width of :func:`mutate_batch` for input width L."""
    return int(length + max(16, length // 2))


def batch_mutation_draws(generator, batch, length, subst_prob, go_prob,
                         ge_prob, alphabet_len=4, *, device="cuda"):
    """The random draws of :func:`mutate_batch`, in the JAX package's
    order and shapes: ``err`` (substitute, bool [B, L]), ``shift``
    (1..|Σ|-1, int [B, L]), ``deleted`` (bool [B, L], at the marginal
    rate ``(go/2)/(1-ge)`` capped at 0.49), ``ins_open`` (bool [B, L],
    at go/2), ``u`` (float32 [B, L] in [1e-7, 1), the insertion runs'
    uniforms) and ``ins_codes`` (int [B, cap], the inserted letters)."""
    device = resolve_device(device)
    _check_generator(generator, device)
    B, L = int(batch), int(length)
    cap = batch_capacity(L)
    rand = lambda: torch.rand((B, L), generator=generator, device=device)
    ints = lambda lo, shape: torch.randint(
        lo, alphabet_len, shape, generator=generator, device=device,
        dtype=torch.int32)
    half_go = float(go_prob) / 2.0
    err = rand() < subst_prob
    shift = ints(1, (B, L))
    deleted = rand() < min(half_go / max(1.0 - float(ge_prob), 1e-6), 0.49)
    ins_open = rand() < half_go
    u = rand() * (1.0 - 1e-7) + 1e-7
    ins_codes = ints(0, (B, cap))
    return {"err": err, "shift": shift, "deleted": deleted,
            "ins_open": ins_open, "u": u, "ins_codes": ins_codes}


_DRAW_TYPES = {"err": torch.bool, "shift": torch.int32,
               "deleted": torch.bool, "ins_open": torch.bool,
               "u": torch.float32, "ins_codes": torch.int32}


def apply_batch_mutations(codes, lengths, draws, ge_prob, alphabet_len=4,
                          max_ins_run=8, *, device="cuda"):
    """Materialise :func:`mutate_batch`'s mutants from its ``draws`` (the
    dict :func:`batch_mutation_draws` returns; numpy arrays or tensors on
    ``device``): substitutions through ``(code + shift) % |Σ|``, kept
    letters, and before each kept or deleted origin position an
    insertion run of ``min(1 + floor(log u / log ge), max_ins_run)``
    letters where ``ins_open``.  Output slot q maps back to its origin
    slot by a row-wise ``searchsorted(..., right=True)`` over the
    cumulative output widths.  Returns ``(codes int8 [B, cap], lengths
    int32 [B])`` with PAD tails."""
    device = resolve_device(device)
    codes = on_device(codes, torch.int32, device)
    lengths = on_device(lengths, torch.int32, device)
    B, L = codes.shape
    cap = batch_capacity(L)
    d = {k: on_device(draws[k], dtype, device)
         for k, dtype in _DRAW_TYPES.items()}
    sub_codes = torch.where(d["err"], (codes + d["shift"]) % alphabet_len,
                            codes)
    if ge_prob > 0:
        # an f32 quotient by a tensor (a scalar divisor would become a
        # multiply by its reciprocal on the card), floored
        log_ge = torch.full_like(d["u"], float(np.log(ge_prob)))
        run = 1.0 + torch.floor(torch.log(d["u"]) / log_ge)
    else:
        run = torch.ones_like(d["u"])
    # capped before the integer cast, so a huge run cannot overflow it
    run = torch.clamp(run, max=float(max_ins_run)).to(torch.int32)
    geo = torch.where(d["ins_open"], run, 0)
    valid = torch.arange(L, device=device)[None, :] < lengths[:, None]
    keep = valid & ~d["deleted"]
    out_w = keep.to(torch.int32) + torch.where(valid, geo, 0)
    ends = torch.cumsum(out_w, dim=1, dtype=torch.int32)    # inclusive
    offs = ends - out_w                                      # exclusive
    mut_lengths = torch.clamp(ends[:, -1], max=cap)

    # invert the ragged expansion: output slot q -> origin slot p
    qidx = torch.arange(cap, dtype=torch.int32, device=device)
    p = torch.searchsorted(ends, qidx[None, :].expand(B, cap).contiguous(),
                           right=True)
    p = torch.clamp(p, max=L - 1)
    rank = qidx[None, :] - torch.gather(offs, 1, p)
    is_ins = rank < torch.gather(geo, 1, p)
    letters = torch.where(is_ins, d["ins_codes"],
                          torch.gather(sub_codes, 1, p))
    mask = qidx[None, :] < mut_lengths[:, None]
    return torch.where(mask, letters, PAD).to(torch.int8), mut_lengths


def mutate_batch(generator, codes, lengths, subst_prob, go_prob, ge_prob,
                 alphabet_len=4, max_ins_run=8, *, device="cuda"):
    """Vectorised mutation of a packed batch (capacity-bounded).

    Every origin position independently draws a substitution through
    the error channel, a deletion flag at the sequential model's
    *marginal* deletion rate ``(go/2)/(1-ge)``, and an insertion run of
    Geometric(ge) length opened with probability go/2; run-length
    coupling of deletions is approximated iid.  The host
    :class:`MutationProcess` is the exact sequential model; this tier
    fabricates large workloads on the device.

    ``codes`` int8 ``[B, L]`` and ``lengths`` int32 ``[B]`` (numpy, or
    tensors on ``device``); ``generator`` a ``torch.Generator`` on
    ``device``.  Returns ``(mut_codes int8 [B, cap], mut_lengths int32
    [B])``, ``cap = L + max(16, L // 2)``, with PAD tails.
    """
    device = resolve_device(device)
    B, L = codes.shape
    draws = batch_mutation_draws(generator, B, L, subst_prob, go_prob,
                                 ge_prob, alphabet_len, device=device)
    return apply_batch_mutations(codes, lengths, draws, ge_prob,
                                 alphabet_len, max_ins_run, device=device)
