"""The port's two-tier protein search (biseqt_tpu_torch.protein) against
the JAX package's (``tests/test_protein.py``'s cases), on the same numpy
inputs.

The JAX side runs its ``lax`` engine, or its Pallas kernel in interpret
mode as its own tests run it; the port runs its reference engine or
K1's plain twin on the CPU.  Scores are exact (integer matrices), and
the fields the two packages share are compared exactly:
``reduced_scores``, ``survivors``, ``survivor_idx``, ``full_scores`` and
``full``'s first S rows (the port compacts survivors to exactly S rows;
the JAX package pads them to a size bucket).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biseqt_tpu import protein as ref
from biseqt_tpu.ops.banded_dp import ModeFlags as RefFlags
from biseqt_tpu_torch import native, protein
from biseqt_tpu_torch.matrices import (BLOSUM62, DAYHOFF6_GROUPS,
                                       MURPHY4_GROUPS, MURPHY10_GROUPS,
                                       PROTEIN_LETTERS, compression_map,
                                       protein_alphabet, reduced_alphabet,
                                       reduced_matrix)
from biseqt_tpu_torch.ops.banded_dp import ModeFlags, banded_dp
from biseqt_tpu_torch.ops.dp_ad import banded_dp_ad, parity_adjusted_dmin
from biseqt_tpu_torch.sequence import Alphabet, Sequence

LOCAL = dict(local_start=True, local_end=True)
SHARED = ("reduced_scores", "survivors", "survivor_idx", "full_scores")


def _protein_batch(rng, B=12, L=96, homolog_frac=0.5):
    """``tests/test_protein.py``'s batch: the first half homologs at 25%
    substitutions, the rest unrelated."""
    ss = rng.integers(0, 20, (B, L)).astype(np.int8)
    ts = np.empty_like(ss)
    n_hom = int(B * homolog_frac)
    for b in range(B):
        if b < n_hom:
            ts[b] = ss[b]
            m = rng.random(L) < 0.25
            ts[b, m] = rng.integers(0, 20, int(m.sum()))
        else:
            ts[b] = rng.integers(0, 20, L)
    lens = np.full((B,), L, np.int32)
    dmin = np.full((B,), -32, np.int32)
    w_eff = np.full((B,), 64, np.int32)
    return ss, ts, lens, dmin, w_eff, n_hom


def _assert_shared_fields_equal(got, want):
    for name in SHARED:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    S = got.survivor_idx.size
    assert np.array_equal(got.survivor_pad, got.survivor_idx)
    if S == 0:
        assert got.full is None and want.full is None
        return
    assert np.array_equal(np.asarray(want.survivor_pad)[:S],
                          got.survivor_idx)
    for name in ("score", "end_i", "end_j"):
        g = getattr(got.full, name).cpu().numpy()
        assert g.shape == (S,), name
        assert np.array_equal(g, np.asarray(getattr(want.full, name))[:S]), \
            name


@pytest.mark.parametrize(
    "groups", [DAYHOFF6_GROUPS, MURPHY10_GROUPS, MURPHY4_GROUPS])
def test_compression_map_and_reduced_matrix_equal_jax(groups):
    from biseqt_tpu import matrices as ref_matrices

    cmap = compression_map(groups)
    assert np.array_equal(cmap, ref_matrices.compression_map(groups))
    for g, members in enumerate(groups):
        assert (cmap == g).sum() == len(members)
        for ch in members:
            assert cmap[PROTEIN_LETTERS.index(ch)] == g
    red = reduced_matrix(BLOSUM62, groups)
    assert np.array_equal(red, ref_matrices.reduced_matrix(
        ref_matrices.BLOSUM62, groups))
    G = len(groups)
    assert np.array_equal(red, red.T) and np.array_equal(red, np.round(red))
    assert np.diagonal(red).mean() > red[~np.eye(G, dtype=bool)].mean()


def test_compress_codes_pads_pass_through():
    cmap = compression_map(DAYHOFF6_GROUPS)
    codes = np.asarray([0, 5, -1, 19, -2], np.int8)
    got = protein.compress_codes(codes, cmap)
    assert got.dtype == np.int8
    assert got[2] == -1 and got[4] == -2
    assert got[0] == cmap[0] and got[3] == cmap[19]
    assert np.array_equal(got, ref.compress_codes(codes, cmap))
    on_tensor = protein.compress_codes(torch.as_tensor(codes), cmap)
    assert on_tensor.dtype == torch.int8
    assert np.array_equal(on_tensor.numpy(), got)


def test_reduce_seq_roundtrip():
    alpha = protein_alphabet()
    seq = Sequence(alpha, np.asarray(
        [PROTEIN_LETTERS.index(c) for c in "ARNDAGPSTILMV"], np.int8))
    red = protein.reduce_seq(seq)
    assert red.alphabet.letters == reduced_alphabet().letters
    assert np.array_equal(red.to_array(),
                          compression_map()[seq.to_array()])
    with pytest.raises(ValueError):
        protein.reduce_seq(Sequence(Alphabet("ACGT"),
                                    np.asarray([0, 1], np.int8)))


def test_null_threshold():
    assert protein.null_threshold([1.0, 7.5, 3.0]) == 12.5
    assert protein.null_threshold(torch.tensor([1.0, 2.0]), 1.0) == 3.0
    assert protein.null_threshold(np.asarray([4.0]), 0.0) == \
        ref.null_threshold(np.asarray([4.0]), 0.0)


def test_two_tier_matches_full_run_and_jax(rng):
    """Survivor rescore scores == full-matrix-only scores, planted
    homologs all survive a null-calibrated threshold, and every shared
    field equals the JAX package's lax-engine result."""
    ss, ts, lens, dmin, w_eff, n_hom = _protein_batch(rng)
    kw = dict(W=64, go=-11.0, ge=-1.0)
    perm = np.stack([rng.permutation(r) for r in ts])
    cmap = compression_map(DAYHOFF6_GROUPS)
    null = banded_dp(protein.compress_codes(ss, cmap),
                     protein.compress_codes(perm, cmap), lens, lens, dmin,
                     subst=reduced_matrix(BLOSUM62, DAYHOFF6_GROUPS),
                     w_eff=w_eff, flags=ModeFlags(**LOCAL), device="cpu",
                     **kw)
    thr = protein.null_threshold(null.score, margin=5.0)
    res = protein.two_tier_scores(ss, ts, lens, lens, dmin, w_eff=w_eff,
                                  threshold=thr, engine="lax",
                                  flags=ModeFlags(**LOCAL), device="cpu",
                                  **kw)
    assert res.survivors[:n_hom].all(), res.reduced_scores
    full = banded_dp(ss, ts, lens, lens, dmin, subst=BLOSUM62, w_eff=w_eff,
                     flags=ModeFlags(**LOCAL), device="cpu", **kw)
    full_np = full.score.numpy()
    assert np.array_equal(res.full_scores[res.survivor_idx],
                          full_np[res.survivor_idx])
    assert np.isinf(res.full_scores[~res.survivors]).all()
    want = ref.two_tier_scores(ss, ts, lens, lens, dmin, w_eff=w_eff,
                               threshold=thr, engine="lax",
                               flags=RefFlags(**LOCAL), **kw)
    _assert_shared_fields_equal(res, want)


@pytest.mark.parametrize("engine", ["lax", "pallas"])
def test_two_tier_engine_opts_contract(rng, engine):
    """Reserved names raise ValueError before anything runs; unknown
    options reach the engine, which refuses them (TypeError); a bad
    engine name raises ValueError."""
    ss, ts, lens, dmin, w_eff, _ = _protein_batch(rng, B=4,
                                                  homolog_frac=0.0)
    kw = dict(W=64 if engine == "lax" else 128, go=-11.0, ge=-1.0,
              flags=ModeFlags(**LOCAL), w_eff=w_eff, threshold=1e9,
              engine=engine, device="cpu")
    for name in sorted(protein._RESERVED):
        with pytest.raises(ValueError, match=name):
            protein.two_tier_scores(ss, ts, lens, lens, dmin,
                                    engine_opts={name: 1}, **kw)
    with pytest.raises(TypeError):
        protein.two_tier_scores(ss, ts, lens, lens, dmin,
                                engine_opts={"no_such_option": 1}, **kw)
    with pytest.raises(ValueError, match="engine"):
        protein.two_tier_scores(ss, ts, lens, lens, dmin,
                                **dict(kw, engine="other"))


@pytest.mark.parametrize("engine", ["lax", "pallas"])
def test_two_tier_no_survivors(rng, engine):
    ss, ts, lens, dmin, w_eff, _ = _protein_batch(rng, B=4,
                                                  homolog_frac=0.0)
    res = protein.two_tier_scores(
        ss, ts, lens, lens, dmin, w_eff=w_eff, threshold=1e9,
        engine=engine, W=64 if engine == "lax" else 128, go=-11.0, ge=-1.0,
        flags=ModeFlags(**LOCAL), device="cpu")
    assert not res.survivors.any() and res.full is None
    assert res.survivor_idx.size == 0 and res.survivor_pad.size == 0
    assert np.isinf(res.full_scores).all()


@pytest.mark.parametrize("groups", [DAYHOFF6_GROUPS, MURPHY10_GROUPS])
def test_reduced_matrix_k1_twin_matches_lax(rng, groups):
    """The filter tier's reduced matrix through K1's plain twin equals the
    reference engine exactly (``test_reduced_matrix_pallas_packed_
    parity``'s batch: one ragged pair)."""
    cmap = compression_map(groups)
    red = reduced_matrix(BLOSUM62, groups)
    A = red.shape[0]
    B, L = 6, 96
    ss = protein.compress_codes(
        rng.integers(0, 20, (B, L)).astype(np.int8), cmap)
    ts = ss.copy()
    m = rng.random((B, L)) < 0.3
    ts[m] = rng.integers(0, A, int(m.sum()))
    lens = np.full((B,), L, np.int32)
    lens[1] = 70
    dmin = np.full((B,), -40, np.int32)
    kw = dict(W=128, subst=red, go=-11.0, ge=-1.0, flags=ModeFlags(**LOCAL),
              w_eff=np.full((B,), 100, np.int32), device="cpu")
    want = banded_dp(ss, ts, lens, lens, dmin, **kw)
    got = banded_dp_ad(ss, ts, lens, lens, dmin, r_chunk=16, **kw)
    assert np.array_equal(got.score.numpy(), want.score.numpy())


@pytest.mark.parametrize("B,threshold", [(8, 100.0), (7, 17.5)])
def test_two_tier_k1_twin_matches_jax_kernel(rng, B, threshold):
    """``engine="pallas"`` with directions: the port (K1's plain twin)
    against the JAX package (its kernel in interpret mode) on the shared
    fields, and the survivors' planes walk to the same transcripts as a
    direct full-matrix run on the survivor pairs (an odd batch and an
    odd survivor count too)."""
    ss, ts, lens, _, _, n_hom = _protein_batch(rng, B=B, L=96)
    w_eff = np.full((B,), 100, np.int32)
    dmin = np.full((B,), -40, np.int32)
    kw = dict(W=128, go=-11.0, ge=-1.0, w_eff=w_eff, threshold=threshold,
              engine="pallas", with_dirs=True)
    res = protein.two_tier_scores(ss, ts, lens, lens, dmin,
                                  flags=ModeFlags(**LOCAL),
                                  engine_opts=dict(r_chunk=16),
                                  device="cpu", **kw)
    want = ref.two_tier_scores(ss, ts, lens, lens, dmin,
                               flags=RefFlags(**LOCAL),
                               engine_opts=dict(interpret=True, block_b=8,
                                                r_chunk=16), **kw)
    _assert_shared_fields_equal(res, want)
    idx = res.survivor_idx
    S = idx.size
    if B == 8:      # test_two_tier_survivor_transcripts' batch
        assert res.survivors[:n_hom].all()
        assert not res.survivors[n_hom:].any()
    else:           # an odd survivor batch: its last plane column half full
        assert S % 2 == 1
    dminq = parity_adjusted_dmin(dmin[idx], np.arange(S, dtype=np.int32) % 2)

    def walk(r):
        ops, _, _ = native.traceback_batch_ad(
            r.dirs.numpy(), dminq, ss[idx], ts[idx], lens[idx], lens[idx],
            r.end_i.numpy(), r.end_j.numpy(), ModeFlags(**LOCAL))
        return ops

    direct = banded_dp_ad(ss[idx], ts[idx], lens[idx], lens[idx], dmin[idx],
                          W=128, subst=BLOSUM62, go=-11.0, ge=-1.0,
                          flags=ModeFlags(**LOCAL), w_eff=w_eff[idx],
                          with_dirs=True, r_chunk=16, device="cpu")
    got_ops, want_ops = walk(res.full), walk(direct)
    assert got_ops == want_ops and all(len(op) > 0 for op in got_ops)
