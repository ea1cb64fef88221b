"""Two-tier protein search: reduced-alphabet filter, full-matrix rescore.

The port of :mod:`biseqt_tpu.protein`.  The reference's C engine
(``pwlib — alnscores``) serves any substitution matrix at full scalar
speed.  The two-tier search is the standard reduced-alphabet strategy
(Murphy et al. 2000):

  1. FILTER: score every candidate pair under a reduced alphabet
     (Dayhoff-6 / Murphy-10) — cheap, slightly noisy scores.
  2. RESCORE: pairs whose filter score clears a threshold are re-aligned
     under the full matrix (exact scores, directions on request).

With filter rate F, full rate G and survivor fraction rho the effective
throughput is 1 / (1/F + rho/G).  Thresholds come from a null
calibration on unrelated pairs (:func:`null_threshold`).

``engine="pallas"`` runs both tiers through the antidiagonal DP kernel
(:func:`.ops.dp_ad.banded_dp_ad`: the CUDA kernel on the card, its plain
twin on the CPU), which keeps the A x A table in shared memory for any
A <= 32; ``engine="lax"`` runs the row-wavefront reference engine
(:func:`.ops.banded_dp.banded_dp`).  The survivors are compacted on
``device`` to exactly S rows: the JAX package's size buckets and packed
substitution planes serve its TPU compiler and are not carried over.

Sequence-level compression for the seeding layers is :func:`reduce_seq`:
the result is an ordinary :class:`~.sequence.Sequence` over the reduced
alphabet, so ``KmerIndex`` / ``SeedIndex`` / ``WordBlot`` run on it
unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .matrices import (BLOSUM62, DAYHOFF6_GROUPS, compression_map,
                       protein_alphabet, reduced_alphabet, reduced_matrix)
from .ops.banded_dp import (DPResult, ModeFlags, banded_dp, on_device,
                            resolve_device)
from .ops.dp_ad import banded_dp_ad
from .sequence import Sequence

__all__ = ["TwoTierResult", "two_tier_scores", "null_threshold",
           "reduce_seq", "compress_codes"]

# arguments two_tier_scores derives itself: engine_opts may not set them
_RESERVED = {"s_codes", "t_codes", "s_lens", "t_lens", "dmin", "W",
             "subst", "A", "go", "ge", "flags", "w_eff", "with_dirs"}


def compress_codes(codes, cmap):
    """Map full protein letter codes to group codes, passing negative
    PAD sentinels through.  Works on numpy arrays and on tensors (on
    their own device)."""
    if isinstance(codes, torch.Tensor):
        cm = torch.as_tensor(np.asarray(cmap), device=codes.device)
        safe = torch.where(codes < 0, 0, codes).to(torch.int64)
        return torch.where(codes < 0, codes, cm[safe].to(codes.dtype))
    cm = np.asarray(cmap)
    safe = np.where(codes < 0, 0, codes)
    return np.where(codes < 0, codes, cm[safe]).astype(codes.dtype)


def reduce_seq(seq: Sequence, groups=DAYHOFF6_GROUPS) -> Sequence:
    """Compress a protein Sequence to the reduced alphabet so the k-mer
    / seed / Word-Blot discovery layers can run on denser group codes."""
    if seq.alphabet.letters != protein_alphabet().letters:
        raise ValueError(
            "reduce_seq expects a sequence over the 20-letter protein "
            "alphabet in matrix row order (matrices.protein_alphabet)")
    cmap = compression_map(groups)
    arr = compress_codes(seq.to_array(), cmap)
    return Sequence(reduced_alphabet(groups), arr)


def null_threshold(null_scores, margin: float = 5.0) -> float:
    """Filter threshold from a null calibration: the max reduced-tier
    score over non-homologous (e.g. shuffled) pairs plus a safety
    margin in score units."""
    if isinstance(null_scores, torch.Tensor):
        null_scores = null_scores.cpu().numpy()
    return float(np.max(np.asarray(null_scores))) + float(margin)


class TwoTierResult(NamedTuple):
    reduced_scores: np.ndarray    # [B] float32, filter-tier scores
    survivors: np.ndarray         # [B] bool, reduced >= threshold
    survivor_idx: np.ndarray      # [S] int32 indices into the batch
    full: Optional[DPResult]      # DP result over the compacted survivor
    #                               batch (S rows on `device`, scores
    #                               exact under the full matrix; row k
    #                               is pair survivor_idx[k]), None if
    #                               S == 0
    full_scores: np.ndarray       # [B] float32; -inf for filtered pairs
    survivor_pad: np.ndarray      # [S] int32 batch index of every row
    #                               of `full` (== survivor_idx: there
    #                               are no filler rows); with
    #                               with_dirs=True it maps `full.dirs`
    #                               rows back to pairs


def two_tier_scores(ss, ts, s_lens, t_lens, dmin, *, W: int, go, ge,
                    flags: ModeFlags, w_eff, subst=None,
                    groups=DAYHOFF6_GROUPS, threshold: float,
                    engine: str = "pallas", with_dirs: bool = False,
                    engine_opts: Optional[dict] = None,
                    device="cuda") -> TwoTierResult:
    """Score a batch of banded protein alignments by the two-tier
    strategy.  Args mirror the DP engines (:func:`.ops.banded_dp.
    banded_dp` / :func:`.ops.dp_ad.banded_dp_ad`): int8 codes over
    :func:`~.matrices.protein_alphabet` (numpy, or tensors on
    ``device``), per-pair lengths and band placement.  ``threshold`` is
    in reduced-tier score units (calibrate with :func:`null_threshold`).

    ``engine_opts`` is forwarded to the DP engine of both tiers (extra
    keyword arguments the engine validates itself); it may not override
    the arguments this function derives (``W``, ``subst``,
    ``with_dirs``, ...): those raise ``ValueError``.
    """
    engine_opts = dict(engine_opts or {})
    bad = _RESERVED & set(engine_opts)
    if bad:
        raise ValueError(
            "engine_opts may not override arguments two_tier_scores "
            f"sets itself: {sorted(bad)} — pass them as named arguments")
    if engine == "pallas":
        dp = banded_dp_ad
    elif engine == "lax":
        dp = banded_dp
    else:
        raise ValueError("engine must be 'pallas' or 'lax'")
    device = resolve_device(device)
    if subst is None:
        subst = BLOSUM62
    cmap = compression_map(groups)
    red = reduced_matrix(subst, groups)
    ss = on_device(ss, torch.int8, device)
    ts = on_device(ts, torch.int8, device)
    s_lens = on_device(s_lens, torch.int32, device)
    t_lens = on_device(t_lens, torch.int32, device)
    dmin = on_device(dmin, torch.int32, device)
    w_eff = on_device(w_eff, torch.int32, device)
    B = ss.shape[0]

    def run(rows, a, b, mat, dirs):
        pick = (lambda x: x) if rows is None else (lambda x: x[rows])
        return dp(pick(a), pick(b), pick(s_lens), pick(t_lens), pick(dmin),
                  W=W, subst=np.asarray(mat, np.float32), go=go, ge=ge,
                  flags=flags, w_eff=pick(w_eff), with_dirs=dirs,
                  device=device, **engine_opts)

    fres = run(None, compress_codes(ss, cmap), compress_codes(ts, cmap), red,
               False)
    reduced_scores = fres.score.cpu().numpy().astype(np.float32)
    survivors = reduced_scores >= float(threshold)
    idx = np.flatnonzero(survivors).astype(np.int32)
    full_scores = np.full((B,), -np.inf, np.float32)
    if idx.size == 0:
        return TwoTierResult(reduced_scores, survivors, idx, None,
                             full_scores, idx)
    rows = torch.as_tensor(idx, dtype=torch.int64, device=device)
    sres = run(rows, ss, ts, subst, with_dirs)
    full_scores[idx] = sres.score.cpu().numpy()
    return TwoTierResult(reduced_scores, survivors, idx, sres, full_scores,
                         idx)
