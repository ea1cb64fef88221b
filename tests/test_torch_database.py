"""The port's sequence database (biseqt_tpu_torch.database) against the
JAX package's, on the same FASTA bytes, on the CPU.

Exact throughout: parsed names, codes and byte offsets (CRLF files
included), the bytes ``write_fasta`` writes, records, content ids,
attrs and codes after ingest by either tier (the C++ packer and the
Python reader), the raised errors, and DB directories, which each
package opens from the other.  The packer's binding is held to the JAX
package's ``fasta_pack``; a packer that fails to build raises instead
of falling back to the Python reader.
"""

import io
import os

import numpy as np
import pytest

from biseqt_tpu import database as ref
from biseqt_tpu import native as ref_native
from biseqt_tpu.sequence import Alphabet, NamedSequence
from biseqt_tpu.stochastics import rand_seq
from biseqt_tpu_torch import database as port
from biseqt_tpu_torch import native
from biseqt_tpu_torch.sequence import from_reference

A4 = Alphabet("ACGT")
P4 = from_reference(A4)

FASTA = """>chr1 description here
ACGTACGTAC
GTACGT
>chr2
TTTTGGGG
"""

# degenerate shapes of test_database.py's parity test, plus CRLF offsets
EDGE_CASES = [
    b">read1 len>500\nACGT\n",
    b">seq1\r\nACGT\r\nGGTT\r\n>seq2\r\nAC\r\n",
    b"> chr1\nACGT\n",
    b"; comment\nrandom junk\n>r1\nACGT\n",
    b">a>b desc\nAC\n",
    b"  >ind\nACGT\n",
    b">e1\n>e2\nAC\n",
    b">r1\nAC\x0bGT\n\x0c>r2\nGG\x0cTT\n",
    b">a desc\nACGT\nacg t\n>b\nTT\nGG\n",
    b">h \xc3\xa9t\xc3\xa9\r\nAC\r\n\r\n>k\r\nGT",
]


def _parsed(mod, f, alphabet, **kw):
    return [(s.name, str(s), pos) for s, pos in mod.read_fasta(f, alphabet,
                                                              **kw)]


def _ingested(db):
    return [(r.id, r.content_id, r.source_file, r.source_pos, r.attrs,
             db.load_from_record(r).to_array().tolist(),
             db.load_from_record(r).name) for r in db.find()]


def _write(tmp_path, name, data):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


@pytest.mark.parametrize("case", range(len(EDGE_CASES)))
def test_read_fasta_matches(tmp_path, case):
    p = _write(tmp_path, "e.fa", EDGE_CASES[case])
    want = _parsed(ref, p, A4)
    assert _parsed(port, p, P4) == want
    assert _parsed(port, p, P4, num=1) == _parsed(ref, p, A4, num=1)
    got = list(port.read_fasta(p, P4))
    assert all(isinstance(s, port.NamedSequence) for s, _ in got)


def test_read_fasta_file_objects_and_offsets():
    assert _parsed(port, io.StringIO(FASTA), P4) == \
        _parsed(ref, io.StringIO(FASTA), A4)
    (_, _, p1), (_, _, p2) = _parsed(port, io.BytesIO(EDGE_CASES[1]), P4)
    assert (p1, p2) == (0, len(b">seq1\r\nACGT\r\nGGTT\r\n"))


def test_write_fasta_writes_the_same_bytes(tmp_path):
    seqs = [NamedSequence(A4, rand_seq(A4, 50, rng=7).contents, name="a"),
            rand_seq(A4, 33, rng=8)]
    ref.write_fasta(str(tmp_path / "ref.fa"), seqs, width=20)
    port.write_fasta(str(tmp_path / "port.fa"),
                     [from_reference(s) for s in seqs], width=20)
    with open(tmp_path / "ref.fa", "rb") as f, \
            open(tmp_path / "port.fa", "rb") as g:
        assert f.read() == g.read()
    back = [s for s, _ in port.read_fasta(str(tmp_path / "port.fa"), P4)]
    assert [str(s) for s in back] == [str(s) for s in seqs]
    assert [s.name for s in back] == ["a", "seq1"]


def test_insert_find_and_events_match():
    def run(mod, alphabet):
        db = mod.DB(":memory:", alphabet)
        seen = []
        db.add_event_listener(
            "sequence-inserted",
            lambda db_, rec, seq: seen.append(
                (rec.content_id, getattr(seq, "name", None))))
        s = alphabet.parse("ACGTACGT")
        first = db.insert(s, attrs={"k": 1})
        dup = db.insert(s)
        recs = db.load_fasta(io.StringIO(FASTA))
        return (first, dup, recs, seen, len(db), db.ids(), _ingested(db),
                [r.attrs for r in db.find(sql_condition="length > 10")],
                [r.id for r in db.find(lambda r: r.attrs.get("k") == 1)])

    got, want = run(port, P4), run(ref, A4)
    assert got[0] == want[0] and got[1] is None and want[1] is None
    assert got[2:] == want[2:]


def test_load_fasta_rc_and_complement_maps_match():
    def run(mod, letters, text, **kw):
        db = mod.DB(":memory:", Alphabet(letters) if mod is ref
                    else from_reference(Alphabet(letters)))
        try:
            recs = db.load_fasta(io.StringIO(text), rc=True, **kw)
        except ValueError as e:
            return ("raised", str(e).split(":")[0], len(db))
        return recs, _ingested(db)

    cases = [("ACGT", ">a\nAACG\n", {}),
             ("ACGTN", ">a\nACGTN\n", {}),
             ("ACGU", ">a\nACGU\n", {}),
             ("ACGU", ">a\nAACG\n", dict(complement_map=["AU", "CG"])),
             ("ACGT", ">a\nAACG\n", dict(complement_map=["AZ"])),
             ("ACGT", ">a\nAACG\n", dict(complement_map={-1: 0})),
             ("ACGT", ">a\nAACG\n", dict(complement_map={5: 0}))]
    for letters, text, kw in cases:
        assert run(port, letters, text, **kw) == run(ref, letters, text, **kw)
    recs, rows = run(port, "ACGT", ">a\nAACG\n")
    assert rows[1][5] == [1, 2, 3, 3]            # CGTT
    assert recs[1].attrs["rc_of"] == recs[0].content_id


@pytest.mark.parametrize("case", range(len(EDGE_CASES)))
@pytest.mark.parametrize("rc", [False, True])
def test_ingest_tiers_match_the_jax_package(tmp_path, case, rc):
    """A path goes through the C++ packer, a file object through the
    Python reader; both tiers give the JAX package's records, with and
    without reverse complements."""
    p = _write(tmp_path, "e.fa", EDGE_CASES[case])
    want = ref.DB(":memory:", A4)
    want.load_fasta(p, rc=rc)
    native_db = port.DB(":memory:", P4)
    native_db.load_fasta(p, rc=rc)
    reader_db = port.DB(":memory:", P4)
    with open(p, "rb") as f:
        reader_db.load_fasta(f, source_file=p, rc=rc)
    assert _ingested(native_db) == _ingested(reader_db) == _ingested(want)


def test_unknown_letters_raise_in_both_tiers(tmp_path):
    for data in (b">r\nACGTNACGT\n", b">r\nAC>GT\n"):
        p = _write(tmp_path, "bad.fa", data)
        with pytest.raises(ValueError, match="not in alphabet"):
            port.DB(":memory:", P4).load_fasta(p)
        with open(p) as f, pytest.raises(ValueError):
            port.DB(":memory:", P4).load_fasta(f)
    # a num-limited load takes the lazy reader: records before the bad
    # letter load
    p = _write(tmp_path, "late.fa", b">ok\nACGT\n>bad\nACNT\n")
    db = port.DB(":memory:", P4)
    assert len(db.load_fasta(p, num=1)) == 1


def test_fasta_pack_matches_the_jax_binding(tmp_path):
    """Codes, offsets, lengths, names and header offsets; names longer
    than the first buffer (1 MiB) take the retry."""
    rng = np.random.default_rng(3)
    letters = np.frombuffer(b"ACGTacgt", np.uint8)
    body = b"".join(
        b">%s d\r\n" % (b"n%d" % k * (300_000 if k in (1, 2) else 1))
        + letters[rng.integers(0, 8, 500)].tobytes() + b"\n  \n"
        for k in range(6))
    p = _write(tmp_path, "big.fa", body)
    got = native.fasta_pack(p)
    want = ref_native.fasta_pack(p)
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert g == w
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert sum(len(n) + 1 for n in got[3]) > 1 << 20
    assert np.array_equal(native.dna_code_map("AC", lowercase=False),
                          ref_native.dna_code_map("AC", lowercase=False))
    with pytest.raises(ValueError, match="256 entries"):
        native.fasta_pack(p, np.zeros(4, np.int8))
    with pytest.raises(OSError):
        native.fasta_pack(str(tmp_path / "missing.fa"))


def test_packer_build_failure_raises(tmp_path, monkeypatch):
    """No quiet Python reader when the C++ tier does not load."""
    p = _write(tmp_path, "g.fa", b">a\nACGT\n")

    def broken():
        raise OSError("libpwnative.so: cannot open shared object file")

    monkeypatch.setattr(native, "_load", broken)
    with pytest.raises(OSError, match="libpwnative"):
        port.DB(":memory:", P4).load_fasta(p)


def test_multichar_alphabet_takes_the_python_reader(tmp_path):
    """An alphabet the byte map cannot express is semantics, not a
    fallback: its files parse by the reader, as in the JAX package."""
    p = _write(tmp_path, "m.fa", b">m\nAACCGG\nTT\n")
    want = ref.DB(":memory:", Alphabet(["AA", "CC", "GG", "TT"]))
    want.load_fasta(p)
    db = port.DB(":memory:", from_reference(
        Alphabet(["AA", "CC", "GG", "TT"])))
    db.load_fasta(p)
    assert _ingested(db) == _ingested(want)
    assert _ingested(db)[0][5] == [0, 1, 2, 3]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_db_directory_opens_in_the_other_package(tmp_path, writer):
    fa = _write(tmp_path, "g.fa", FASTA.encode() + b">chr3\nACG\n")
    path = str(tmp_path / "db.sqlite")
    w_mod, r_mod = (ref, port) if writer == "jax" else (port, ref)
    w_alpha, r_alpha = (A4, P4) if writer == "jax" else (P4, A4)
    db = w_mod.DB(path, w_alpha)
    db.load_fasta(fa, rc=True)
    db.insert(w_alpha.parse("ACGTAA"), attrs={"k": [1, 2]})
    written = _ingested(db)
    db.close()
    assert sorted(os.listdir(path + ".seqs")) == sorted(
        r[1] + ".npy" for r in written)
    other = r_mod.DB(path, r_alpha)
    assert _ingested(other) == written
    (codes, lengths), recs = other.packed_batch()
    assert lengths.tolist() == [16, 16, 8, 8, 3, 3, 6]
    # the reader appends; the writer sees it
    other.insert(r_alpha.parse("TTTT"))
    other.close()
    again = w_mod.DB(path, w_alpha)
    assert len(again) == 8 and str(again.load_from_record(
        list(again.find())[-1])) == "TTTT"


def test_packed_batch_matches():
    def run(mod, alphabet):
        db = mod.DB(":memory:", alphabet)
        db.load_fasta(io.StringIO(FASTA))
        (codes, lengths), recs = db.packed_batch(pad_to=20)
        return codes, lengths, [r.content_id for r in recs]

    got, want = run(port, P4), run(ref, A4)
    assert np.array_equal(got[0], want[0]) and got[0].dtype == np.int8
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]
