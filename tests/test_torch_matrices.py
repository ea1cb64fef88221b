"""The port's copy of the substitution matrices
(biseqt_tpu_torch.matrices) against the JAX package's, and
tests/test_matrices.py's checks rerun against the copy.

The checks that drive an Aligner run through the port's Aligner: the
protein path against the numpy oracle (exactly: the matrices and gap
scores are integers), and its kernel backends (plain twins here)
against its reference engine.
"""

import numpy as np
import pytest

import biseqt_tpu.matrices as ref
import test_matrices as ref_matrix_tests
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import matrices, pw
from biseqt_tpu_torch.sequence import from_reference

from oracle import dp_oracle


def test_copy_equals_reference():
    assert matrices.__all__ == ref.__all__
    assert matrices.PROTEIN_LETTERS == ref.PROTEIN_LETTERS
    assert matrices.protein_alphabet() == from_reference(
        ref.protein_alphabet())
    for name in ("BLOSUM62", "PAM250"):
        got, want = getattr(matrices, name), getattr(ref, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for groups in ("DAYHOFF6_GROUPS", "MURPHY10_GROUPS", "MURPHY4_GROUPS"):
        g = getattr(ref, groups)
        assert getattr(matrices, groups) == g
        np.testing.assert_array_equal(matrices.compression_map(g),
                                      ref.compression_map(g))
        assert matrices.reduced_alphabet(g) == from_reference(
            ref.reduced_alphabet(g))
        np.testing.assert_array_equal(matrices.reduced_matrix(groups=g),
                                      ref.reduced_matrix(groups=g))
    with pytest.raises(ValueError, match="partition"):
        matrices.compression_map(("AC",))


def test_matrix_landmarks_on_copy(monkeypatch):
    """tests/test_matrices.py::test_matrix_landmarks on the copy."""
    monkeypatch.setattr(ref_matrix_tests, "BLOSUM62", matrices.BLOSUM62)
    monkeypatch.setattr(ref_matrix_tests, "PAM250", matrices.PAM250)
    ref_matrix_tests.test_matrix_landmarks()


def protein_pair(rng, n):
    P = ref.protein_alphabet()
    S = rand_seq(P, n, rng=rng)
    M = MutationProcess(P, subst_probs=0.1, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    T, _ = M.mutate(S)
    return from_reference(S), from_reference(T)


@pytest.mark.parametrize("name,go,ge", [
    ("BLOSUM62", -11.0, -1.0),   # classic BLAST-style gap penalties
    ("PAM250", -10.0, -2.0),
])
def test_protein_alignment_matches_oracle(rng, name, go, ge):
    """tests/test_matrices.py::test_protein_alignment_matches_oracle
    through the port's Aligner."""
    subst = getattr(matrices, name)
    S, T = protein_pair(rng, 80)
    with pw.Aligner(S, T, alnmode=pw.STD_MODE, alntype=pw.GLOBAL,
                    subst_scores=subst, go_score=go, ge_score=ge,
                    device="cpu") as aln:
        score = aln.solve()
        assert score == dp_oracle(S.contents, T.contents, subst, go, ge)
        assert aln.traceback().calculate_score(subst, go, ge) == score


@pytest.mark.parametrize("backend", ["pallas", "pallas_row"])
def test_protein_banded_kernel_backends_match_lax(rng, backend):
    """BLOSUM62 through the kernel backends (their shared-memory table
    path, plain twins here) gives the reference engine's alignment."""
    S, T = protein_pair(rng, 90)
    d0 = len(S) - len(T)
    kw = dict(alnmode=pw.BANDED_MODE, alntype=pw.B_GLOBAL,
              diag_range=(min(d0, 0) - 10, max(d0, 0) + 10),
              subst_scores=matrices.BLOSUM62, go_score=-11.0, ge_score=-1.0)
    out = []
    for be in ("lax", backend):
        with pw.Aligner(S, T, backend=be, device="cpu", **kw) as aln:
            out.append((aln.solve(), str(aln.traceback().transcript)))
    assert out[1] == out[0]
