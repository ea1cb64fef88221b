"""The one traffic generator: inputs made from a seed and a configuration.

Plain PyTorch, vectorised over a whole batch and drawn on the run's
device from a ``torch.Generator`` seeded with the run's seed, so that a
batch of thousands of 10 kbp pairs takes milliseconds of set-up on a
card.  The same seed gives the same inputs on the same kind of device.
"""

import torch


def generator(seed, device):
    """The run's generator.  Seeds may be any whole number (the driver's
    pass 32 signed bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _ragged_arange(lens):
    """``[0, 1, ..., lens[0] - 1, 0, 1, ..., lens[1] - 1, ...]``."""
    ends = torch.cumsum(lens, 0)
    at = torch.arange(int(ends[-1]), device=lens.device)
    return at - torch.repeat_interleave(ends - lens, lens)


def _interleave(first, first_lens, second, second_lens):
    """The concatenation ``first[0], second[0], first[1], second[1],
    ...`` of two ragged lists, each given flat with its lengths."""
    lens = torch.stack([first_lens, second_lens], 1).reshape(-1)
    starts = torch.cumsum(lens, 0) - lens
    out = torch.empty(int(lens.sum()), dtype=first.dtype, device=first.device)
    out[torch.repeat_interleave(starts[0::2], first_lens)
        + _ragged_arange(first_lens)] = first
    out[torch.repeat_interleave(starts[1::2], second_lens)
        + _ragged_arange(second_lens)] = second
    return out, starts


def planted_pairs(g, n, cfg):
    """S and T holding ``n`` homologous blocks between random spacers,
    and one candidate segment per block, as discovery would emit it.

    Each block of ``cfg["block"]`` letters is copied into T with
    ``cfg["sub"]`` substitutions (a uniform other letter) and
    ``cfg["indels"]`` short indels of ``cfg["indel_len"]`` letters at
    distinct positions at least ``cfg["indel_margin"]`` from its ends,
    each an insertion into T or a deletion from T with equal odds, so
    the diagonal drifts by at most indels x the longest indel.  Spacers
    of ``cfg["spacer"]`` letters (half-open range) precede every block
    in S and in T.  The segment is the planted diagonal +- band / 2 over
    the block's antidiagonals.  Returns ``(s_codes, t_codes, segments)``
    with the codes int8 numpy arrays on the host."""
    dev = g.device
    A = len(cfg["alphabet"])
    L, k = int(cfg["block"]), int(cfg["indels"])
    lo_len, hi_len = cfg["indel_len"]
    margin = int(cfg["indel_margin"])
    rand = lambda *shape: torch.rand(shape, generator=g, device=dev)
    ints = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=g,
                                                device=dev)
    core = ints(0, A, n, L).to(torch.int8)
    hit = rand(n, L) < cfg["sub"]
    mut = torch.where(hit, (core + ints(1, A, n, L)) % A, core).to(torch.int8)
    # k distinct sorted positions in [margin, L - margin)
    pos = torch.sort(ints(margin, L - margin - (k - 1), n, k), 1).values \
        + torch.arange(k, device=dev)
    lens = ints(lo_len, hi_len + 1, n, k)
    insert = rand(n, k) < 0.5
    ins = torch.zeros((n, L), dtype=torch.int64, device=dev)
    ins.scatter_add_(1, pos, torch.where(insert, lens, 0))
    keep = torch.ones((n, L), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand(n, k)
    for off in range(hi_len):
        gone = ~insert & (off < lens)
        keep[rows[gone], (pos + off)[gone].clamp(max=L - 1)] = False
    # inserted letters come before the kept letter of their position
    width = (ins + keep).reshape(-1)
    t_len = (ins + keep).sum(1)
    copies = ints(0, A, int(t_len.sum())).to(torch.int8)
    copies[(torch.cumsum(width, 0) - 1)[keep.reshape(-1)]] = mut[keep]
    sp_lo, sp_hi = cfg["spacer"]
    gaps = ints(sp_lo, sp_hi, n, 2)
    spacers = ints(0, A, int(gaps.sum())).to(torch.int8)
    sp_lens = gaps.reshape(-1)
    sp_at = torch.cumsum(sp_lens, 0) - sp_lens
    # each side's spacers, in block order
    take = lambda side: spacers[torch.repeat_interleave(
        sp_at[side::2], gaps[:, side]) + _ragged_arange(gaps[:, side])]
    S, s_starts = _interleave(take(0), gaps[:, 0], core.reshape(-1),
                              torch.full((n,), L, device=dev))
    T, t_starts = _interleave(take(1), gaps[:, 1], copies, t_len)
    i0 = s_starts[1::2].tolist()
    j0 = t_starts[1::2].tolist()
    t_len = t_len.tolist()
    half = int(cfg["band"]) // 2
    segments = [{"segment": ((i - j - half, i - j + half),
                             (i + j, i + L + j + tl))}
                for i, j, tl in zip(i0, j0, t_len)]
    return S.cpu().numpy(), T.cpu().numpy(), segments


def channel(rng, core, sub, go, ge, A=4, geometry=None):
    """``core`` through the reference biseqt mutation process
    (``MutationProcess(subst_probs=sub, go_prob=go, ge_prob=ge).mutate``)
    in distribution, vectorised: before each origin letter it visits, the
    process opens insertion runs (each with probability go / 2, extended
    with probability ge), then deletes the letter and opens a deletion
    run (go / 2) or copies it through the substitution channel (1 - go; a
    uniform other letter with probability sub).  A deletion run's later
    letters are not visited.  The indels are drawn from ``geometry`` (a
    numpy generator; ``rng`` if None), the substitutions and every letter
    from ``rng``.  Copied from the repository's smoke run of the
    genome-homology configuration, with the two streams split."""
    import numpy as np

    geo = rng if geometry is None else geometry
    L = len(core)
    runs = geo.geometric(1 - go / 2, L) - 1
    run_lens = geo.geometric(1 - ge, int(runs.sum()))
    ins = np.zeros(L, np.int64)
    np.add.at(ins, np.repeat(np.arange(L), runs), run_lens)
    dele = geo.random(L) < (go / 2) / (1 - go / 2)
    del_lens = geo.geometric(1 - ge, L)
    visited = np.ones(L, bool)
    covered_to = 0
    for i in np.flatnonzero(dele):
        if i < covered_to:            # inside an earlier deletion run
            dele[i] = False
            continue
        covered_to = i + del_lens[i]
        visited[i + 1:covered_to] = False
        dele[i + 1:covered_to] = False
    ins = np.where(visited, ins, 0)
    copy = visited & ~dele
    letters = core.copy()
    hit = rng.random(L) < sub
    letters[hit] = (letters[hit] + rng.integers(1, A, int(hit.sum()))) % A
    width = ins + copy
    out = rng.integers(0, A, int(width.sum())).astype(np.int8)
    out[(np.cumsum(width) - width + ins)[copy]] = letters[copy]
    return out


def rearranged_pair(seed, cfg):
    """Genome A of ``cfg["size"]`` letters and genome B, A's
    ``cfg["blocks"]`` blocks each through :func:`channel` (``cfg["sub"]``,
    gap open and extend ``cfg["gap"]``) in the order ``cfg["order"]``;
    with the truth blocks ``(start in A, start in B, length in B)``.
    Numpy on the host.  The seed draws A's letters and the substitutions
    and letters of the channel; the order and the indels (drawn from
    ``cfg["layout_seed"]``) are the configuration's, so that every seed
    gives the same segments, windows and launches: which blocks merge,
    and on which diagonals each block's alignment lies, fix the work."""
    import numpy as np

    rng = np.random.default_rng(int(seed) % (1 << 64))
    geometry = np.random.default_rng(int(cfg["layout_seed"]))
    A = len(cfg["alphabet"])
    size, n_blocks = int(cfg["size"]), int(cfg["blocks"])
    a = rng.integers(0, A, size).astype(np.int8)
    block = size // n_blocks
    chunks, truth, pos_b = [], [], 0
    for b in cfg["order"]:
        a_lo = int(b) * block
        mut = channel(rng, a[a_lo:a_lo + block], cfg["sub"], cfg["gap"],
                      cfg["gap"], A, geometry)
        chunks.append(mut)
        truth.append((a_lo, pos_b, len(mut)))
        pos_b += len(mut)
    return a, np.concatenate(chunks), truth
