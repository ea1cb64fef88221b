"""Sort-join all-vs-all overlap statistics (the at-scale path).

The port of :mod:`biseqt_tpu.ops.allvsall_sorted`, the all-vs-all
analog of the reference's SQL self-join (``biseqt/seeds.py —
SeedIndex``):

  1. ONE global sorted k-mer table over all reads
     (:func:`.tables.build_kmer_table`);
  2. seeds materialise as a *capped run expansion*: every table entry
     pairs with the next ``max_run`` entries of its k-mer run (repetitive
     k-mers beyond the cap are dropped);
  3. each seed becomes one int32 composite ``(query, target, d-bucket)``
     key; one more sort and a run-length count give every pair's
     diagonal histogram *sparsely*;
  4. sliding 3-bucket windows come from neighbouring composites, and a
     per-pair max over a background-corrected rank picks the best
     overlap band.

Plain PyTorch on ``device`` (``"cuda"`` by default; numpy inputs are
copied there, tensors must already live there): the JAX package does
this work in XLA outside any Pallas kernel.  Every float32 operation of
the rank and the statistics is the JAX package's, in its order, because
the rank truncates a float to an integer and so picks the winning
bucket.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import blot_stats
from .banded_dp import on_device, resolve_device
from .tables import build_kmer_table, KEY_SENTINEL

__all__ = ["auto_max_run", "overlap_stats_sorted",
           "overlap_stats_sorted_chunked"]

BIG = 2 ** 31 - 1          # the composite of a slot that holds no seed


def auto_max_run(n_reads: int, L: int, wordlen: int,
                 alphabet_len: int = 4) -> int:
    """Partner cap sized to the expected k-mer run length.

    In all-vs-all the mean run length is mu = N*L / |Sigma|^w.  A cap
    far below mu samples a biased sliver of each run (entries are
    (key, read, pos)-sorted, so far-apart read indices almost never land
    within the cap) and true pairs' seed counts collapse.  Cost is
    linear in the cap, so it is also bounded by an element budget:
    2 * cap * total_kmers <= 256M.  Where the budget starves the cap
    below its statistical floor a ``RuntimeWarning`` says so: raise
    ``wordlen`` or pass ``max_run`` explicitly.
    """
    mu = n_reads * max(L, 1) / float(alphabet_len ** wordlen)
    cap = int(np.clip(np.ceil(2.5 * mu), 8, 96))
    budget = (256 << 20) // max(2 * n_reads * L, 1)
    out = max(1, min(cap, budget))
    if out < min(cap, 8):
        warnings.warn(
            "auto_max_run: the expansion budget caps the k-mer partner "
            "window at %d while the expected run length is ~%.0f — "
            "overlap seed counts WILL be undercounted; raise wordlen "
            "(fewer collisions per key) or pass max_run explicitly"
            % (out, mu), RuntimeWarning, stacklevel=2)
    return out


def overlap_stats_sorted_chunked(codes, lengths, *, wordlen: int,
                                 n_reads: int, alphabet_len: int = 4,
                                 bucket: int = 64, max_run: int = None,
                                 max_chunk: int = None,
                                 min_window: int = 5, device="cuda"):
    """:func:`overlap_stats_sorted` for any N: where the int32 composite
    key (q_local * N * nbins) would overflow, query rows are scored in
    equal windows of ``(2**31 - 1) // (nbins * N)`` rows (at most
    ``max_chunk``), the last window shifted back to overlap rather than
    shrunk — the JAX package's windows, so its results.  Returns the
    same dict of ``[N, N]`` tensors on ``device``.
    """
    device = resolve_device(device)
    codes = on_device(codes, torch.int8, device)
    lengths = on_device(lengths, torch.int32, device)
    N, L = codes.shape
    if N != n_reads:
        raise ValueError("n_reads %d != %d rows" % (n_reads, N))
    nbins = (2 * L) // bucket + 2
    limit = max(int((2 ** 31 - 1) // (nbins * N)), 1)
    if max_chunk is not None:
        limit = min(limit, int(max_chunk))
    kw = dict(wordlen=wordlen, n_reads=n_reads, alphabet_len=alphabet_len,
              bucket=bucket, max_run=max_run, min_window=min_window,
              device=device)
    if limit >= N:
        return overlap_stats_sorted(codes, lengths, **kw)
    out = None
    q_lo = 0
    while q_lo < N:
        if q_lo + limit > N:
            q_lo = N - limit          # shifted last window (same shape)
        part = overlap_stats_sorted(codes, lengths, n_local=limit,
                                    q_lo=q_lo, **kw)
        if out is None:
            out = {k: torch.zeros((N,) + tuple(v.shape[1:]), dtype=v.dtype,
                                  device=device) for k, v in part.items()}
        for k, v in part.items():
            out[k][q_lo:q_lo + limit] = v
        q_lo += limit
    return out


def overlap_stats_sorted(codes, lengths, *, wordlen: int, n_reads: int,
                         alphabet_len: int = 4, bucket: int = 64,
                         max_run: int = None, n_local: int = None,
                         q_lo: int = None, min_window: int = 5,
                         device="cuda"):
    """Best-overlap-band statistics for every ordered read pair.

    Args:
        codes: int8 [N, L]; lengths: int32 [N]; ``n_reads`` == N.
        bucket: diagonal bucket width (band resolution).
        max_run: per-entry partner cap within a k-mer run (repeat
            guard); None sizes it with :func:`auto_max_run`.
        n_local / q_lo: restrict query rows to the window
            ``[q_lo, q_lo + n_local)`` (the row block of one rank of a
            sharded run).
        min_window: windows below this seed count never win.

    Returns a dict of ``[n_local or N, N]`` tensors on ``device``:
    ``window`` (best 3-bucket band seed count), ``diag`` (band centre
    diagonal, d = pos_q - pos_t), ``p`` (match-probability estimate),
    ``s0`` (H0 score), ``olap_len``.
    """
    device = resolve_device(device)
    codes = on_device(codes, torch.int8, device)
    lengths = on_device(lengths, torch.int32, device)
    if max_run is None:
        max_run = auto_max_run(n_reads, codes.shape[1], wordlen,
                               alphabet_len)
    N, L = codes.shape
    if N != n_reads:
        raise ValueError("n_reads %d != %d rows" % (n_reads, N))
    if n_local is None:
        n_local, q_lo = N, 0
    q_lo = int(q_lo)
    nbins = (2 * L) // bucket + 2
    n_pairs = n_local * N
    if n_pairs * nbins >= 2 ** 31:
        raise ValueError("composite key overflows int32; raise bucket or "
                         "shard reads")

    comp = _composites(codes, lengths, wordlen, alphabet_len, int(max_run),
                       n_local, q_lo, nbins, bucket)
    uniq, cnt = _runs(comp)
    window, pair_id, dbin = _windows(uniq, cnt, nbins, n_pairs, min_window)

    # rank rows by background-corrected excess (raw counts favour long
    # bands whose larger background explains their seeds): excess =
    # n - E[bg] - 3*sqrt(E[bg]), from the real per-pair lengths
    lens_f = lengths.to(torch.float32)
    per_letter = _f32_const(float(alphabet_len) ** -wordlen, device)
    pair64 = pair_id.to(torch.int64)
    qlen_r = lens_f[q_lo + pair64 // N]
    tlen_r = lens_f[pair64 % N]
    d_r = (dbin * bucket + bucket // 2 - L).to(torch.float32)
    bg = _background(qlen_r, tlen_r, d_r, bucket, per_letter)
    excess = window.to(torch.float32) - bg - 3.0 * torch.sqrt(bg + 1.0)
    # the encoded (rank, dbin) pair must fit int32: cap the rank so
    # rank_cap * nbins + nbins < 2^31
    rank_cap = min(2 ** 22, (2 ** 31 - 1) // max(int(nbins), 1) - 1)
    rank_q = torch.clamp(excess * 16.0, 0, rank_cap).to(torch.int32)
    # winning bucket: per-pair max over the encoded (rank, dbin); the
    # winner's window count is rebuilt from its rank and its bucket's
    # background
    enc = rank_q * nbins + dbin
    best_enc = torch.zeros(n_pairs, dtype=torch.int32, device=device)
    best_enc.scatter_reduce_(0, pair64, enc, "amax")
    best_bin = best_enc % nbins
    best_rank = (best_enc // nbins).to(torch.float32) / 16.0
    pid_all = torch.arange(n_pairs, dtype=torch.int64, device=device)
    qlen_b = lens_f[q_lo + pid_all // N]
    tlen_b = lens_f[pid_all % N]
    d_b = (best_bin * bucket + bucket // 2 - L).to(torch.float32)
    bg_best = _background(qlen_b, tlen_b, d_b, bucket, per_letter)
    best_w = torch.where(
        best_rank > 0,
        best_rank + bg_best + 3.0 * torch.sqrt(bg_best + 1.0),
        0.0).to(torch.int32)

    # geometry and statistics per pair
    qlen = lens_f[q_lo:q_lo + n_local][:, None]
    tlen = lens_f[None, :]
    centers = (best_bin.reshape(n_local, N) * bucket + bucket // 2) - L
    d = centers.to(torch.float32)
    olap = torch.clamp(_overlap(qlen, tlen, d), min=0.0)
    seglen = torch.clamp(olap, min=1.0)
    w = best_w.reshape(n_local, N).to(torch.float32)
    p_hat = blot_stats.estimate_match_probability(w, seglen, wordlen,
                                                  device=device)
    area = (3.0 * bucket) * seglen
    s0, _ = blot_stats.h0_h1_scores(
        w, area, seglen, torch.clamp(p_hat, min=1e-3), wordlen,
        alphabet_len, device=device)
    plausible = olap >= 2.0 * wordlen
    return {
        "window": best_w.reshape(n_local, N),
        "diag": centers.to(torch.int32),
        "p": torch.where(plausible, p_hat, 0.0),
        "s0": torch.where(plausible, s0, 0.0),
        "olap_len": olap.to(torch.int32),
    }


def _f32_const(x: float, device) -> torch.Tensor:
    """``x`` rounded once to float32 (|Σ|^-w: exact for powers of two,
    and the value XLA folds for other alphabets)."""
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


def _overlap(qlen, tlen, d):
    return torch.minimum(torch.minimum(qlen - d, tlen + d),
                         torch.minimum(qlen, tlen))


def _background(qlen, tlen, d, bucket: int, per_letter):
    """Expected background seeds of a 3-bucket band centred on diagonal
    d: ``3 * bucket * seglen * |Σ|^-w``, multiplied in the JAX package's
    order."""
    seglen = torch.clamp(_overlap(qlen, tlen, d), min=1.0)
    return (3.0 * bucket) * seglen * per_letter


def _composites(codes, lengths, wordlen, alphabet_len, max_run, n_local,
                q_lo, nbins, bucket):
    """The capped run expansion as int32 composites ``(q_local * N + t) *
    nbins + d_bucket`` in one preallocated array of ``2 * max_run *
    B*L`` slots, both directions of every seed, each masked by query
    ownership of the row window (``BIG`` where a slot holds no owned
    seed).  Composites are formed in int64 and masked before the int32
    cast, so rows the window does not own never wrap."""
    N, L = codes.shape
    keys, seqs, poss, _ = build_kmer_table(codes, lengths, wordlen,
                                           alphabet_len,
                                           device=codes.device)
    M = keys.shape[0]
    sentinel = int(KEY_SENTINEL)
    comp = torch.empty(2 * max_run * M, dtype=torch.int32,
                       device=codes.device)
    seqs64, poss64 = seqs.to(torch.int64), poss.to(torch.int64)
    for h in range(1, max_run + 1):
        n = M - h                     # entries with an h-th successor
        valid = (keys[:n] == keys[h:]) & (keys[:n] != sentinel)
        valid &= seqs[:n] != seqs[h:]  # seeds across distinct reads only
        sa, sb = seqs64[:n], seqs64[h:]
        pa, pb = poss64[:n], poss64[h:]
        for slot, (q, t, d) in enumerate(((sa, sb, pa - pb),
                                          (sb, sa, pb - pa))):
            local = q - q_lo
            own = valid & (local >= 0) & (local < n_local)
            d = torch.clamp(d + L, 0, 2 * L)
            key = (local * N + t) * nbins + d // bucket
            out = comp[(2 * (h - 1) + slot) * M:(2 * (h - 1) + slot + 1) * M]
            out[:n] = torch.where(own, key, BIG).to(torch.int32)
            out[n:] = BIG
    return comp


def _runs(comp):
    """The distinct owned composites in ascending order and each one's
    seed count (one sort, a run-length count)."""
    comp = torch.sort(comp).values
    uniq, cnt = torch.unique_consecutive(comp, return_counts=True)
    keep = uniq < BIG
    return uniq[keep], cnt[keep].to(torch.int32)


def _windows(uniq, cnt, nbins: int, n_pairs: int, min_window: int):
    """3-bucket sliding windows over each pair's sparse diagonal
    histogram: a row's neighbours are the adjacent rows at composite +-1,
    within the same pair only.  Windows below ``min_window`` are 0.
    Returns ``(window, pair_id, dbin)`` per distinct composite."""
    dev = uniq.device
    dbin = uniq % nbins
    minus2 = torch.full((1,), -2, dtype=torch.int32, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    left = torch.cat([minus2, uniq[:-1]])
    lcnt = torch.cat([zero, cnt[:-1]])
    right = torch.cat([uniq[1:], minus2])
    rcnt = torch.cat([cnt[1:], zero])
    window = (cnt
              + torch.where((left == uniq - 1) & (dbin > 0), lcnt, 0)
              + torch.where((right == uniq + 1) & (dbin < nbins - 1),
                            rcnt, 0))
    window = torch.where(window >= min_window, window, 0)
    pair_id = torch.clamp(uniq // nbins, 0, n_pairs - 1)
    return window.to(torch.int32), pair_id, dbin
