"""Sorted-array table ops: k-mer packing, sorted tables, merge joins.

The port of :mod:`biseqt_tpu.ops.tables`, the device tier of seed
discovery (it replaces the reference's SQLite-backed ``KmerIndex`` and
``SeedIndex`` storage):

* k-mers pack to int32 keys by base-|Σ| positional encoding, a sum of
  ``wordlen`` shifted scalings;
* the "index" is the triple of arrays ``(key, seq, pos)`` sorted
  lexicographically; lookups are ``searchsorted``;
* the seed join between two sequences' k-mer lists expands every
  query's hit run into (query, table) pairs by inverting the cumulative
  hit count with a ``searchsorted``.

Plain PyTorch on the device (``device="cuda"`` by default; numpy inputs
are copied there, tensors must already live there): the JAX package
does this work in XLA outside any Pallas kernel.  The JAX package's
static capacities (compile-cache buckets for the TPU) are not carried
over: a join emits exactly its seeds.

Windows that overrun their row or hold a PAD letter get
``KEY_SENTINEL`` (int32 max), so they sort to the end and fall out of
every searchsorted range.
"""

from __future__ import annotations

import numpy as np
import torch

from .banded_dp import on_device, resolve_device

KEY_SENTINEL = np.int32(np.iinfo(np.int32).max)
# the most seeds a join may emit: the JAX package counts them in int32
MAX_SEEDS = int(np.iinfo(np.int32).max)

__all__ = [
    "KEY_SENTINEL",
    "MAX_SEEDS",
    "kmer_keys",
    "build_kmer_table",
    "hit_ranges",
    "expand_join",
    "seed_total",
    "seed_join",
    "seed_join_sorted",
    "nway_shared_seeds",
    "run_boundaries",
]


def _keys(codes, lengths, wordlen: int, alphabet_len: int):
    """:func:`kmer_keys` on tensors already on their device."""
    if alphabet_len ** wordlen >= 2 ** 31:
        raise ValueError(
            "alphabet_len**wordlen must fit int32; got %d^%d"
            % (alphabet_len, wordlen))
    B, L = codes.shape
    codes_i = codes.to(torch.int32)
    c = torch.clamp(codes_i, min=0)
    key = torch.zeros((B, L), dtype=torch.int32, device=codes.device)
    # a negative code INSIDE the window (an ambiguous base coded -1
    # mid-sequence) sentinels the window too, not aliasing to base 0
    has_pad = torch.zeros((B, L), dtype=torch.bool, device=codes.device)
    for t in range(min(wordlen, L)):
        key[:, :L - t] += c[:, t:] * (alphabet_len ** (wordlen - 1 - t))
        has_pad[:, :L - t] |= codes_i[:, t:] < 0
    pos = torch.arange(L, dtype=torch.int32, device=codes.device)[None, :]
    valid = (pos + wordlen <= lengths.reshape(-1, 1)) & ~has_pad
    return torch.where(valid, key, int(KEY_SENTINEL))


def kmer_keys(codes, lengths, wordlen: int, alphabet_len: int = 4, *,
              device="cuda"):
    """Pack every k-window of each row into an int32 key.

    ``codes``: int8 ``[B, L]`` (PAD = -1 outside ``lengths``).  Window t of
    row b covers positions ``[t, t+wordlen)``; windows overrunning the row
    length (or containing PAD) get ``KEY_SENTINEL``.  Returns int32
    ``[B, L]``.  |Σ|^wordlen must fit int32 (wordlen <= 15 for DNA);
    ``ValueError`` otherwise.
    """
    device = resolve_device(device)
    return _keys(on_device(codes, torch.int8, device),
                 on_device(lengths, torch.int32, device), wordlen,
                 alphabet_len)


def build_kmer_table(codes, lengths, wordlen: int, alphabet_len: int = 4, *,
                     device="cuda"):
    """The sorted (key, seq, pos) k-mer table of a packed batch.

    Returns ``(keys, seqs, poss, n_valid)``: int32 arrays of length
    ``B*L`` sorted lexicographically by (key, seq, pos), sentinel rows at
    the end, and ``n_valid`` the number of real k-mer occurrences.
    """
    device = resolve_device(device)
    codes = on_device(codes, torch.int8, device)
    L = codes.shape[1]
    keys = _keys(codes, on_device(lengths, torch.int32, device), wordlen,
                 alphabet_len).reshape(-1)
    # (seq, pos) is the flat order already, so one stable sort by key
    # gives the (key, seq, pos) order
    keys, order = torch.sort(keys, stable=True)
    order = order.to(torch.int32)
    n_valid = (keys != int(KEY_SENTINEL)).sum().to(torch.int32)
    return keys, order // L, order % L, n_valid


def _ranges(table_keys, query_keys):
    start = torch.searchsorted(table_keys, query_keys, side="left",
                               out_int32=True)
    end = torch.searchsorted(table_keys, query_keys, side="right",
                             out_int32=True)
    return start, end


def hit_ranges(table_keys, query_keys, *, device="cuda"):
    """For each query key, its [start, end) run in a sorted key array."""
    device = resolve_device(device)
    return _ranges(on_device(table_keys, torch.int32, device).contiguous(),
                   on_device(query_keys, torch.int32, device).contiguous())


def _expand(starts, counts):
    counts = counts.to(torch.int64)
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if counts.shape[0] else 0
    if total > MAX_SEEDS:
        raise OverflowError(
            "a join of %d pairs exceeds 2^31 - 1 (the JAX package's int32"
            " count wraps there)" % total)
    slot = torch.arange(total, dtype=torch.int64, device=counts.device)
    q = torch.searchsorted(ends, slot, side="right")
    rank = slot - (ends - counts)[q]
    t = starts.to(torch.int64)[q] + rank
    return q.to(torch.int32), t.to(torch.int32)


def expand_join(starts, counts, *, device="cuda"):
    """Invert a ragged expansion into gathers.

    Given per-query hit-run starts and counts, give each output slot
    ``n < sum(counts)`` the (query_index, table_index) pair it stands
    for, in query-major order: ``query_of[n] = searchsorted(cumsum(
    counts), n, 'right')`` and ``table_of[n] = starts[q] + (n -
    offset[q])``.

    Returns ``(query_idx, table_idx)``, int32 arrays of length
    ``sum(counts)``.

    Overflow contract: past 2^31 - 1 pairs (where the JAX package's int32
    total wraps negative) it raises ``OverflowError``.
    """
    device = resolve_device(device)
    return _expand(on_device(starts, torch.int32, device),
                   on_device(counts, torch.int64, device))


def _pair_keys(codes0, len0, codes1, len1, wordlen, alphabet_len, device):
    codes0 = on_device(codes0, torch.int8, device).reshape(1, -1)
    codes1 = on_device(codes1, torch.int8, device).reshape(1, -1)
    k0 = _keys(codes0, on_device([int(len0)], torch.int32, device), wordlen,
               alphabet_len)[0]
    k1 = _keys(codes1, on_device([int(len1)], torch.int32, device), wordlen,
               alphabet_len)[0]
    return k0, k1


def seed_total(codes0, len0, codes1, len1, wordlen: int,
               alphabet_len: int = 4, *, device="cuda") -> int:
    """The exact number of seeds between a pair, without materializing
    them."""
    device = resolve_device(device)
    k0, k1 = _pair_keys(codes0, len0, codes1, len1, wordlen, alphabet_len,
                        device)
    starts, ends = _ranges(torch.sort(k1).values, k0)
    counts = torch.where(k0 != int(KEY_SENTINEL), ends - starts, 0)
    return int(counts.to(torch.int64).sum())


def _join(codes0, len0, codes1, len1, wordlen, alphabet_len, device):
    k0, k1 = _pair_keys(codes0, len0, codes1, len1, wordlen, alphabet_len,
                        device)
    L1 = k1.shape[0]
    # T's k-mers sorted by key, carrying their positions
    sk1, sp1 = torch.sort(k1, stable=True)
    starts, ends = _ranges(sk1, k0)
    counts = torch.where(k0 != int(KEY_SENTINEL), ends - starts, 0)
    qi, ti = _expand(starts, counts)
    return {"i": qi, "j": sp1[ti.to(torch.int64)].to(torch.int32)}


def seed_join(codes0, len0, codes1, len1, wordlen: int,
              alphabet_len: int = 4, *, device="cuda"):
    """Enumerate exact k-mer matches (seeds) between two sequences: T's
    k-mers are sorted once, every S window's run in them is found by
    binary search, and the runs are expanded into pairs with
    :func:`expand_join`.

    Args:
        codes0/1: int8 ``[L]`` code rows (PAD tail ok).
        len0/1: the rows' lengths.

    Returns a dict of int32 arrays, one slot per seed: ``i`` (position
    in S) and ``j`` (position in T).  Seeds come in ascending ``i``; the
    order of
    one ``i``'s seeds is unspecified (the JAX package sorts T's keys
    with an unstable sort).
    """
    return _join(codes0, len0, codes1, len1, wordlen, alphabet_len,
                 resolve_device(device))


def seed_join_sorted(codes0, len0, codes1, len1, wordlen: int,
                     alphabet_len: int = 4, *, device="cuda"):
    """:func:`seed_join`, the band-coordinate transform and the (d_, a)
    sort, all on the device: the SeedIndex build path.

    Returns a dict of int32 arrays, one slot per seed: ``d_`` (= i - j
    + len1, ascending) and ``a`` (= i + j, the secondary key).  (d_, a)
    fixes (i, j), so the order is total.
    """
    device = resolve_device(device)
    out = _join(codes0, len0, codes1, len1, wordlen, alphabet_len, device)
    d_ = (out["i"] - out["j"] + int(len1)).to(torch.int64)
    a = (out["i"] + out["j"]).to(torch.int64)
    # one sort of the composite key d_ * stride + a, a < stride
    stride = int(np.shape(codes0)[-1]) + int(np.shape(codes1)[-1])
    comp = torch.sort(d_ * stride + a).values
    return {"d_": (comp // stride).to(torch.int32),
            "a": (comp % stride).to(torch.int32)}


def nway_shared_seeds(codes, lengths, wordlen: int, alphabet_len: int = 4,
                      *, device="cuda"):
    """The (key, seq, pos)-sorted k-mer table over N sequences, the device
    half of first-hit N-way seed discovery.  Returns ``(keys, seqs,
    poss)``, int32, sentinel keys at the tail."""
    keys, seqs, poss, _ = build_kmer_table(codes, lengths, wordlen,
                                           alphabet_len, device=device)
    return keys, seqs, poss


def run_boundaries(sorted_keys, *, device="cuda"):
    """Start flags and run ids over a sorted key array: ``(is_start
    bool[N], run_id int32[N])``, ``run_id`` the 0-based index of each
    distinct run (sentinel runs included)."""
    device = resolve_device(device)
    keys = on_device(sorted_keys, torch.as_tensor(sorted_keys).dtype, device)
    prev = torch.cat([torch.full((1,), -1, dtype=keys.dtype, device=device),
                      keys[:-1]])
    is_start = keys != prev
    run_id = torch.cumsum(is_start.to(torch.int32), 0).to(torch.int32) - 1
    return is_start, run_id
