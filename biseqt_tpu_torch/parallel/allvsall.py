"""Sharded all-vs-all overlap discovery (the noisy-long-read config).

The port of :mod:`biseqt_tpu.parallel.allvsall`.  The reference ran
Word-Blot overlap detection pair by pair (``biseqt/blot.py —
WordBlotOverlap`` over every read pair); here:

  1. every read's k-mers are packed and sorted along the read (the
     per-read mini-index);
  2. reads shard across the mesh's ``data`` axis: each rank owns a row
     block of the pair matrix;
  3. each rank all-gathers the reads (``all_gather_into_tensor`` on the
     data axis's group) and scores its query block against all of them:
     for each query k-mer a binary search finds its hit run in the
     target's sorted table, and a capped hit expansion adds into a
     per-pair *diagonal-bucket histogram*;
  4. sliding 3-bucket windows and the H0 / H1 scores give each pair's
     best overlap band, p̂ and significance.

Every rank returns the whole ``[N, N]`` result on the host (one more
all-gather of the row blocks), as the JAX package's single-controller
call does.  In a world of one no collective is called.  Plain PyTorch
on ``device`` (the card by default): the JAX package runs this in XLA
outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import blot_stats
from ..ops.banded_dp import _host, on_device, resolve_device
from ..ops.tables import KEY_SENTINEL, kmer_keys
from .mesh import DATA_AXIS, make_mesh

__all__ = ["all_vs_all_overlaps", "overlap_matrix_sharded",
           "overlap_matrix_sorted_sharded", "overlap_stats_block"]

STATS = ("num_seeds", "diag", "p", "s0", "olap_len")
SORTED_STATS = ("window", "diag", "p", "s0", "olap_len")


def _pair_diag_histograms(qk, t_sorted_keys, t_sorted_pos, nbins: int,
                          bucket: int, max_hits: int):
    """Diagonal-bucket seed histograms of every (query, target) pair of
    a block: ``qk`` [Nq, L] query keys (sentinel for invalid windows),
    ``t_sorted_*`` [C, L] the targets' sorted k-mer mini-indexes.
    Returns int32 [Nq, C, nbins]: the count of seeds whose diagonal d =
    i - j (shifted by L) falls in each bucket, the first ``max_hits``
    entries of each query k-mer's hit run counted."""
    Nq, L = qk.shape
    C = t_sorted_keys.shape[0]
    dev = qk.device
    keys = t_sorted_keys[None].expand(Nq, C, L).contiguous()
    pos = t_sorted_pos[None].expand(Nq, C, L)
    q = qk[:, None, :].expand(Nq, C, L).contiguous()
    lo = torch.searchsorted(keys, q, side="left")
    hi = torch.searchsorted(keys, q, side="right")
    real = q != int(KEY_SENTINEL)
    ii = torch.arange(L, device=dev)
    base = (torch.arange(Nq * C, device=dev) * nbins).reshape(Nq, C, 1)
    counts = torch.zeros(Nq * C * nbins, dtype=torch.int32, device=dev)
    for h in range(max_hits):
        idx = lo + h
        valid = (idx < hi) & real
        j = torch.gather(pos, 2, torch.clamp(idx, 0, L - 1))
        b = torch.clamp(torch.div(ii - j + L, bucket, rounding_mode="floor"),
                        0, nbins - 1)
        counts.index_add_(0, (base + b).reshape(-1),
                          valid.to(torch.int32).reshape(-1))
    return counts.reshape(Nq, C, nbins)


def overlap_stats_block(q_codes, q_lens, t_codes, t_lens, *, wordlen: int,
                        alphabet_len: int = 4, bucket: int = 32,
                        max_hits: int = 4, target_chunk: int = 32,
                        device="cuda"):
    """Best-overlap statistics for every (query, target) pair of a block.

    Args:
        q_codes: int8 [Nq, L]; t_codes: int8 [Nt, L] (same padded L);
        q_lens / t_lens int32 (numpy, or tensors on ``device``).
        max_hits: hits counted per query k-mer and target (the first
            ``max_hits`` of its run in the target's table, ties in
            position order).
        target_chunk: targets scored at once (peak temporaries are
            ``[Nq, target_chunk, L]``).

    Returns a dict of ``[Nq, Nt]`` tensors on ``device``: ``num_seeds``
    (best band seed count), ``diag`` (best band centre diagonal), ``p``
    (match-probability estimate), ``s0`` (H0 score), ``olap_len``.
    """
    device = resolve_device(device)
    q_lens = on_device(q_lens, torch.int32, device)
    t_lens = on_device(t_lens, torch.int32, device)
    qk = kmer_keys(q_codes, q_lens, wordlen, alphabet_len, device=device)
    tk = kmer_keys(t_codes, t_lens, wordlen, alphabet_len, device=device)
    Nq, L = qk.shape
    Nt = tk.shape[0]
    nbins = (2 * L) // bucket + 1
    t_sorted_keys, order = torch.sort(tk, dim=1, stable=True)

    # targets stream in chunks so the searchsorted temporaries stay
    # [Nq, target_chunk, L]
    C = min(target_chunk, Nt)
    hists = torch.cat([
        _pair_diag_histograms(qk, t_sorted_keys[c0:c0 + C],
                              order[c0:c0 + C], nbins, bucket, max_hits)
        for c0 in range(0, Nt, C)], dim=1)

    # 3-bucket sliding window over diagonals = band of width ~3*bucket
    padded = torch.nn.functional.pad(hists, (1, 1))
    window = padded[:, :, :-2] + padded[:, :, 1:-1] + padded[:, :, 2:]

    # per-bucket expected overlap length from the band centre diagonal
    centers = (torch.arange(nbins, device=device) * bucket + bucket // 2) - L
    ls = q_lens[:, None, None].to(torch.float32)
    lt = t_lens[None, :, None].to(torch.float32)
    d = centers[None, None, :].to(torch.float32)
    olap = torch.clamp(torch.minimum(torch.minimum(ls - d, lt + d),
                                     torch.minimum(ls, lt)), min=0.0)
    seglen = torch.clamp(olap, min=1.0)

    w = window.to(torch.float32)
    p_hat = blot_stats.estimate_match_probability(w, seglen, wordlen,
                                                  device=device)
    area = (3.0 * bucket) * seglen
    s0, _ = blot_stats.h0_h1_scores(
        w, area, seglen, torch.clamp(p_hat, min=1e-3), wordlen,
        alphabet_len, device=device)
    # rank bands by H0 significance: p̂·K favours long sparse bands;
    # -log p-value normalises for band area
    ok = (olap >= 2.0 * wordlen) & (window >= 5)
    rank = torch.where(ok, s0, -1.0)
    best = torch.argmax(rank, dim=2, keepdim=True)
    take = lambda arr: torch.gather(arr, 2, best)[:, :, 0]
    return {
        "num_seeds": take(window),
        "diag": centers[best[:, :, 0]].to(torch.int32),
        "p": take(p_hat),
        "s0": take(s0),
        "olap_len": take(olap).to(torch.int32),
    }


def _padded_rows(codes, lengths, n_data: int):
    """Reads padded to a whole number of rows per rank (PAD rows of
    length 0), on the host."""
    codes, lengths = _host(codes), _host(lengths)
    N, L = codes.shape
    Np = ((N + n_data - 1) // n_data) * n_data
    codes_p = np.full((Np, L), -1, np.int8)
    codes_p[:N] = codes.astype(np.int8)
    lens_p = np.zeros((Np,), np.int32)
    lens_p[:N] = lengths.astype(np.int32)
    return codes_p, lens_p


def _all_gather_rows(x, mesh):
    """The data axis's row blocks, concatenated in rank order."""
    if mesh.device_mesh is None:
        return x
    x = x.contiguous()
    out = torch.empty((mesh.shape[DATA_AXIS] * x.shape[0],) + x.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.data_group)
    return out


def _row_block(codes, lengths, mesh, device):
    """This rank's query block of the padded reads, and all the reads
    gathered over the data axis: ``(q_codes, q_lens, codes_all,
    lens_all, q_lo)``."""
    n_data = mesh.shape[DATA_AXIS]
    codes_p, lens_p = _padded_rows(codes, lengths, n_data)
    n_local = codes_p.shape[0] // n_data
    q_lo = mesh.data_rank * n_local
    q_codes = on_device(codes_p[q_lo:q_lo + n_local], torch.int8, device)
    q_lens = on_device(lens_p[q_lo:q_lo + n_local], torch.int32, device)
    return (q_codes, q_lens, _all_gather_rows(q_codes, mesh),
            _all_gather_rows(q_lens, mesh), q_lo)


def _whole_matrix(stats, names, mesh, N: int):
    return {k: _all_gather_rows(stats[k], mesh).cpu().numpy()[:N, :N]
            for k in names}


def overlap_matrix_sharded(codes, lengths, *, wordlen: int = 8,
                           alphabet_len: int = 4, bucket: int = 32,
                           max_hits: int = 4, mesh=None, device="cuda"):
    """All-vs-all overlap statistics (:func:`overlap_stats_block`), reads
    sharded over the mesh's data axis.

    Each rank scores its query row block against the full read set
    (the targets arrive by all-gather).  Returns a dict of ``[N, N]``
    host arrays on every rank.
    """
    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(device=device)
    N = _host(codes).shape[0]
    q_codes, q_lens, t_codes, t_lens, _ = _row_block(codes, lengths, mesh,
                                                     device)
    stats = overlap_stats_block(q_codes, q_lens, t_codes, t_lens,
                                wordlen=wordlen, alphabet_len=alphabet_len,
                                bucket=bucket, max_hits=max_hits,
                                device=device)
    return _whole_matrix(stats, STATS, mesh, N)


def overlap_matrix_sorted_sharded(codes, lengths, *, wordlen: int = 8,
                                  alphabet_len: int = 4, bucket: int = 64,
                                  max_run: int = None, mesh=None,
                                  device="cuda"):
    """Mesh-sharded sort-join all-vs-all: each rank owns a row block.

    ``max_run=None`` sizes the partner cap to the expected (global,
    coverage-scaled) k-mer run length (:func:`..ops.allvsall_sorted.
    auto_max_run`).  The reads replicate by all-gather (each rank
    rebuilds the k-mer table, one sort); the quadratic part — pair
    composites, the big sort, the per-pair statistics — is sharded by
    query rows.  Returns a dict of ``[N, N]`` host arrays on every rank.
    """
    from ..ops.allvsall_sorted import overlap_stats_sorted

    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(device=device)
    N = _host(codes).shape[0]
    q_codes, _, codes_all, lens_all, q_lo = _row_block(codes, lengths, mesh,
                                                       device)
    stats = overlap_stats_sorted(
        codes_all, lens_all, wordlen=wordlen, n_reads=codes_all.shape[0],
        alphabet_len=alphabet_len, bucket=bucket, max_run=max_run,
        n_local=q_codes.shape[0], q_lo=q_lo, device=device)
    return _whole_matrix(stats, SORTED_STATS, mesh, N)


def all_vs_all_overlaps(codes, lengths, *, wordlen: int = 8,
                        min_score: float = 25.0, min_p: float = 0.5,
                        min_olap_len: int = 0, method: str = "auto",
                        device="cuda", **kw):
    """Significant overlap pairs from the all-vs-all matrix.

    ``method``: ``"sorted"`` (the sort-join engine, chunked past the
    int32 composite ceiling), ``"blockwise"`` (the mesh-sharded per-pair
    search, :func:`overlap_matrix_sharded`, which takes the rest of
    ``kw``), or ``"auto"`` (blockwise only when a ``mesh`` is passed).

    Returns a list of ``(q, t, diag, p, s0)`` with q < t, filtered by the
    H0 score, match-probability and overlap-length thresholds.
    """
    device = resolve_device(device)
    N = _host(codes).shape[0]
    if method == "auto":
        method = "blockwise" if kw.get("mesh") is not None else "sorted"
    if method == "sorted":
        from ..ops.allvsall_sorted import overlap_stats_sorted_chunked

        stats = {k: v.cpu().numpy() for k, v in overlap_stats_sorted_chunked(
            _host(codes).astype(np.int8), _host(lengths).astype(np.int32),
            wordlen=wordlen, n_reads=int(N),
            alphabet_len=kw.get("alphabet_len", 4),
            bucket=kw.get("bucket", 32),
            # None = auto_max_run: the global table's run length scales
            # with coverage
            max_run=kw.get("max_hits", None), device=device).items()}
    else:
        stats = overlap_matrix_sharded(codes, lengths, wordlen=wordlen,
                                       device=device, **kw)
    # vectorised upper-triangle extraction
    N = stats["p"].shape[0]
    mask = ((stats["s0"] >= min_score) & (stats["p"] >= min_p)
            & (stats["olap_len"] >= min_olap_len)
            & np.triu(np.ones((N, N), bool), k=1))
    qq, tt = np.nonzero(mask)
    return [(int(q), int(t), int(d), float(p), float(s))
            for q, t, d, p, s in zip(qq, tt, stats["diag"][qq, tt],
                                     stats["p"][qq, tt],
                                     stats["s0"][qq, tt])]
