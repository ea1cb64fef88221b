"""Device-side Word-Blot statistics: grid histograms, band scores.

The port of :mod:`biseqt_tpu.ops.blot_stats`, the compute tier under
:mod:`..blot`.  The reference scored candidate bands by per-band SQL
seed counts and KDTree neighbour queries; here the same statistics come
from dense (diagonal, antidiagonal) bucket grids:

* an integer scatter-add builds a (d-cell, a-cell) histogram of seeds,
* a 3x3 shifted sum gives every cell its band-neighbourhood count,
* per-diagonal counts and prefix sums give O(1) sliding-band sums for
  overlap detection,
* the H0 / H1 scores and p̂ are float32 elementwise math.

Plain PyTorch on ``device`` (``"cuda"`` by default; numpy inputs are
copied there, tensors must already live there): the JAX package does
this work in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..stochastics import binomial_to_normal, normal_neg_log_pvalue
from .banded_dp import on_device, resolve_device

__all__ = [
    "grid_counts", "box_sum3", "sliding_band_sums",
    "h0_h1_scores", "estimate_match_probability",
]


def grid_counts(d_cells, a_cells, n_dcells: int, n_acells: int, *,
                device="cuda"):
    """Histogram seeds into a (d-cell, a-cell) grid by an integer
    scatter-add.

    ``d_cells``/``a_cells``: int32 [N] quantized coordinates, one per
    seed (clipped to the grid).  Returns int32 [n_dcells, n_acells].
    """
    device = resolve_device(device)
    d = torch.clamp(on_device(d_cells, torch.int64, device), 0, n_dcells - 1)
    a = torch.clamp(on_device(a_cells, torch.int64, device), 0, n_acells - 1)
    g = torch.zeros(n_dcells * n_acells, dtype=torch.int32, device=device)
    g.index_add_(0, d * n_acells + a,
                 torch.ones(d.shape, dtype=torch.int32, device=device))
    return g.reshape(n_dcells, n_acells)


def box_sum3(grid, *, device="cuda"):
    """3x3 neighbourhood sum of an integer grid (replaces per-seed KDTree
    radius queries): with d-cell size = band radius r and a-cell size =
    segment window, the 3x3 window around a seed's cell covers its
    (±r, ±window) neighbourhood up to quantization."""
    device = resolve_device(device)
    grid = on_device(grid, torch.int32, device)
    D, A = grid.shape
    padded = torch.zeros((D + 2, A + 2), dtype=grid.dtype, device=device)
    padded[1:D + 1, 1:A + 1] = grid
    out = torch.zeros_like(grid)
    for dd in (0, 1, 2):
        for da in (0, 1, 2):
            out += padded[dd:dd + D, da:da + A]
    return out


def sliding_band_sums(diag_counts, radius, *, device="cuda"):
    """Seed count of every diagonal band [d - r, d + r] via prefix sums.

    ``diag_counts``: int32 [D] per-diagonal seed counts.  Returns int32
    [D] window sums.
    """
    device = resolve_device(device)
    counts = on_device(diag_counts, torch.int32, device)
    c = torch.cumsum(counts, 0).to(torch.int32)
    D = counts.shape[0]
    idx = torch.arange(D, device=device)
    r = int(radius)
    hi = torch.clamp(idx + r, 0, D - 1)
    lo = torch.clamp(idx - r - 1, -1, D - 1)
    return c[hi] - torch.where(lo >= 0, c[lo], 0)


def _integer_pow(x, n: int):
    """``x ** n`` for a Python int n by binary exponentiation: XLA's
    ``integer_pow``, product for product (``jnp`` arrays raised to a
    Python int lower to it)."""
    acc = None
    while n:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def _f32(x, device):
    return on_device(x, torch.float32, device)


def h0_h1_scores(num_seeds, area, seglen, p_match, wordlen: int,
                 alphabet_len: int = 4, *, device="cuda"):
    """Log-likelihood scores of a band's seed count under H0 and H1.

    The core Word-Blot statistic:

    * H0 (unrelated): seeds fall in the band area at the background rate
      ``|Σ|^-w``, n ~ Binomial(area, |Σ|^-w).  S0 = -log P(N >= n | H0):
      a big S0 says the count is inexplicable by chance.
    * H1 (related, match prob p): a segment of ``seglen`` alignment
      columns contributes ~ seglen * p^w seeds.  S1 = -log P(N >= n | H1):
      a small S1 is consistent with a homology at ``p_match``.

    Normal approximations with stable log tails, float32, vectorized.
    Returns ``(S0, S1)`` tensors.
    """
    device = resolve_device(device)
    num_seeds = _f32(num_seeds, device)
    # |Σ|^-w rounded once to float32 (exact for powers of two)
    p0 = torch.tensor(float(alphabet_len) ** -wordlen, dtype=torch.float32,
                      device=device)
    mu0, sd0 = binomial_to_normal(_f32(area, device), p0, device=device)
    # floor sd0 like sd1: in the sparse (Poisson) regime the raw normal
    # tail overstates significance 4-13x
    sd0 = torch.clamp(sd0, min=1.0)
    s0 = normal_neg_log_pvalue(mu0, sd0, num_seeds, device=device)

    pw_ = _integer_pow(_f32(p_match, device), int(wordlen))
    mu1, sd1 = binomial_to_normal(_f32(seglen, device), pw_, device=device)
    sd1 = torch.clamp(sd1, min=1.0)
    s1 = normal_neg_log_pvalue(mu1, sd1, num_seeds, device=device)
    return s0, s1


def estimate_match_probability(num_seeds, seglen, wordlen: int, *,
                               device="cuda"):
    """p̂ = (n / K)^(1/w): invert E[seeds] ≈ K p^w, in float32.

    The root is taken in float64 and rounded once to float32 (the
    exponent is float32's 1/w, as in the JAX package), so every device
    gives the same bits: float32 ``pow`` differs by an ulp between the
    card and the host, and S1 at p = p̂ cancels n against K p̂^w, which
    turns one ulp of p̂ into ~4e-4 of S1 at genome-scale counts.
    """
    device = resolve_device(device)
    n = _f32(num_seeds, device)
    K = torch.clamp(_f32(seglen, device), min=1.0)
    root = float(np.float32(1.0 / wordlen))
    p = ((n / K).to(torch.float64) ** root).to(torch.float32)
    return torch.clamp(p, 0.0, 1.0)
