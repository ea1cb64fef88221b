"""The port's pairwise API (biseqt_tpu_torch.pw) against the JAX
package's (biseqt_tpu.pw).

The same pairs (made by the JAX package's simulator, carried across with
``sequence.from_reference``) go through both Aligners, backend by
backend, in every alntype: scores equal, transcripts and start cells
identical, and every transcript rescores to its score exactly.  The
port's ``pallas_row`` and ``pallas`` backends run their kernels' plain
twins here and are held to the JAX ``lax`` backend (the JAX kernels
are slow in interpret mode).  Then tests/test_pw.py's own tests run
against the port's Aligner.
"""

import inspect

import pytest

import test_pw as ref_pw_tests
from biseqt_tpu import pw as ref_pw
from biseqt_tpu.matrices import BLOSUM62, protein_alphabet
from biseqt_tpu.sequence import Alphabet
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import pw
from biseqt_tpu_torch.sequence import from_reference

A4 = Alphabet("ACGT")
ALL_TYPES = ([(pw.STD_MODE, t) for t in pw.STD_TYPES]
             + [(pw.BANDED_MODE, t) for t in pw.BANDED_TYPES])


def pairs(rng, alphabet=A4, n=(70, 95), sub=0.12):
    out = []
    for length in n:
        S = rand_seq(alphabet, length, rng=rng)
        M = MutationProcess(alphabet, subst_probs=sub, go_prob=0.05,
                            ge_prob=0.2, rng=rng)
        T, _ = M.mutate(S)
        out.append((S, T))
    return out


def align(module, S, T, **kw):
    """Solve and traceback; returns (score, transcript, starts, rescored)."""
    if module is pw:
        S, T = from_reference(S), from_reference(T)
        kw = dict(kw, device="cpu")
    with module.Aligner(S, T, **kw) as aln:
        score = aln.solve()
        alignment = aln.traceback()
    if score is None:
        return None, None, None, None
    return (score, str(alignment.transcript),
            (alignment.origin_start, alignment.mutate_start),
            alignment.calculate_score(aln.subst_scores, aln.go_score,
                                      aln.ge_score))


def kwargs(alnmode, alntype, S, T, **kw):
    kw = dict(alnmode=alnmode, alntype=alntype, go_score=-2.5,
              ge_score=-1.0, **kw)
    if alnmode == pw.BANDED_MODE:
        d0 = len(S) - len(T)
        kw["diag_range"] = (min(d0, 0) - 9, max(d0, 0) + 9)
    return kw


@pytest.mark.parametrize("alnmode,alntype", ALL_TYPES)
@pytest.mark.parametrize("backend", ["lax", "native"])
def test_aligner_matches_reference(rng, backend, alnmode, alntype):
    for S, T in pairs(rng):
        kw = kwargs(alnmode, alntype, S, T, backend=backend)
        got = align(pw, S, T, **kw)
        assert got == align(ref_pw, S, T, **kw)
        assert got[3] == got[0]


@pytest.mark.parametrize("alntype", pw.BANDED_TYPES)
@pytest.mark.parametrize("backend", ["pallas_row", "pallas"])
def test_kernel_backends_match_reference_lax(rng, backend, alntype):
    """The kernel backends (plain twins on the CPU) give the JAX lax
    backend's scores and rescore exactly; the row kernel also gives its
    transcripts."""
    for S, T in pairs(rng):
        kw = kwargs(pw.BANDED_MODE, alntype, S, T)
        got = align(pw, S, T, backend=backend, **kw)
        want = align(ref_pw, S, T, backend="lax", **kw)
        assert got[0] == want[0] and got[3] == got[0]
        if backend == "pallas_row":
            assert got == want


@pytest.mark.parametrize("alntype", pw.BANDED_TYPES)
@pytest.mark.parametrize("backend", ["pallas_row", "pallas"])
def test_kernel_backends_take_bands_above_4096_lanes(rng, backend, alntype):
    """``diag_range=(-2100, 2100)``: 4201 diagonals, which both kernel
    backends round up to W 5120 (a cluster of blocks on the card).  The
    plain twins give the JAX lax backend's scores and rescore exactly;
    the row kernel also gives its transcripts."""
    kw = dict(alnmode=pw.BANDED_MODE, alntype=alntype, go_score=-2.5,
              ge_score=-1.0, diag_range=(-2100, 2100))
    assert pw._bucket(4201 + (backend == "pallas"), mini=128) == 5120
    for S, T in pairs(rng):
        got = align(pw, S, T, backend=backend, **kw)
        want = align(ref_pw, S, T, backend="lax", **kw)
        assert got[0] == want[0] and got[3] == got[0]
        if backend == "pallas_row":
            assert got == want


def test_pallas_row_protein_defect_not_inherited(rng):
    """The JAX Aligner's row-kernel route never passes the alphabet size
    to its kernel, whose default is 4, so a 20-letter matrix raises
    there; the port's takes it from the alphabet and gives the lax
    backend's alignment."""
    P = protein_alphabet()
    (S, T), = pairs(rng, P, n=(100,))
    kw = dict(alnmode=pw.BANDED_MODE, alntype=pw.B_LOCAL,
              diag_range=(-20, 20), subst_scores=BLOSUM62, go_score=-11.0,
              ge_score=-1.0)
    with pytest.raises(IndexError):
        align(ref_pw, S, T, backend="pallas_row", **kw)
    got = align(pw, S, T, backend="pallas_row", **kw)
    assert got == align(ref_pw, S, T, backend="lax", **kw)
    assert got[0] > 200 and got[3] == got[0]


def test_aligner_api_contract(rng):
    (S, T), = pairs(rng, n=(40,))
    S, T = from_reference(S), from_reference(T)
    banded = dict(alnmode=pw.BANDED_MODE, alntype=pw.B_LOCAL,
                  diag_range=(-8, 8), go_score=-2.0, ge_score=-1.0)
    with pw.Aligner(S, T, backend="pallas_row", device="cpu",
                    **banded) as aln:
        score = aln.solve()
        assert not aln._result_has_dirs and aln._result.dirs.numel() == 0
        alignment = aln.traceback()
        assert aln._result_has_dirs
        res = aln._result
        assert str(aln.traceback().transcript) == str(alignment.transcript)
        assert aln._result is res              # directions solved once
    assert alignment.score == score
    with pytest.raises(AssertionError):
        pw.Aligner(S, T, alnmode=pw.STD_MODE, backend="pallas_row",
                   device="cpu")
    with pytest.raises(AssertionError):
        pw.Aligner(S, T, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        pw.Aligner(S, T, device="meta")
    with pytest.raises(AssertionError, match="context manager"):
        pw.Aligner(S, T, device="cpu").solve()


# tests/test_pw.py's tests whose only JAX-package dependence is the
# Aligner they drive (the others call the JAX engines directly; their
# counterparts are in tests/test_torch_banded_dp.py)
PW_TESTS = [
    ("test_std_modes_match_oracle", ref_pw_tests.STD_CASES),
    ("test_banded_modes_match_oracle",
     [(pw.B_GLOBAL, dict()),
      (pw.B_LOCAL, dict(local_start=True, local_end=True)),
      (pw.B_OVERLAP, dict(free_start_edges=True, free_end_edges=True))]),
    ("test_traceback_rescores_to_optimum",
     [(pw.STD_MODE, t) for t in pw.STD_TYPES[:5]]
     + [(pw.BANDED_MODE, t) for t in pw.BANDED_TYPES]),
    ("test_banded_equals_full_when_band_covers", [()]),
    ("test_identity_alignment", [()]),
    ("test_local_alignment_finds_planted_homology", [()]),
    ("test_overlap_mode_suffix_prefix", [()]),
    ("test_infeasible_band_returns_none", [()]),
]


class _PortAligner:
    """The port's Aligner behind the JAX package's constructor: carries
    the JAX package's sequences across, on the CPU."""

    def __new__(cls, origin, mutate, **kw):
        return pw.Aligner(from_reference(origin), from_reference(mutate),
                          device="cpu", **kw)


@pytest.mark.parametrize("name,params", [
    (name, p) for name, cases in PW_TESTS for p in cases])
def test_pw_reference_tests_on_port(name, params, rng, monkeypatch):
    """Each listed test of tests/test_pw.py, case by case, with the JAX
    package's ``pw`` module and ``Aligner`` swapped for the port's."""
    monkeypatch.setattr(ref_pw_tests, "pw", pw)
    monkeypatch.setattr(ref_pw_tests, "Aligner", _PortAligner)
    fn = getattr(ref_pw_tests, name)
    takes_rng = "rng" in inspect.signature(fn).parameters
    fn(*(((rng,) if takes_rng else ()) + tuple(params)))
