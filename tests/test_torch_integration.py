"""The end-to-end user story of tests/test_integration.py through the
port alone, on the CPU, against the JAX package's run of the same story.

FASTA file -> DB -> k-mer index (through the DB's event hook) ->
Word-Blot discovery -> batched banded extension with transcripts; and
the mapping story: a reference and reads in the DB, a read index, each
read mapped against the reference by ``WordBlotLocalRef`` and extended
with a transcript.  Exact: records, the index's table, segments, scores,
transcripts and start cells equal the JAX package's (its extension by
the Pallas kernels in interpret mode); p̂ to rtol 1e-5, atol 1e-6.
"""

import numpy as np

import biseqt_tpu.pipeline as ref_pipeline
from biseqt_tpu.blot import WordBlot, WordBlotLocalRef
from biseqt_tpu.database import DB as RefDB
from biseqt_tpu.kmers import KmerIndex as RefKmerIndex
from biseqt_tpu.sequence import Alphabet
from biseqt_tpu.sequence import NamedSequence as RefNamedSequence
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import blot, pipeline
from biseqt_tpu_torch.database import DB, write_fasta
from biseqt_tpu_torch.kmers import KmerIndex
from biseqt_tpu_torch.pw import Alignment
from biseqt_tpu_torch.sequence import NamedSequence, from_reference

A4 = Alphabet("ACGT")
P4 = from_reference(A4)
UNIT = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
EKW = dict(subst=UNIT, go_score=-3.0, ge_score=-1.0)


def _key(out):
    return [(s["segment"], s["num_seeds"], s["score"], s["transcript"],
             s["origin_start"], s["mutate_start"]) for s in out]


def _rescores(S, T, out):
    for seg in out:
        aln = Alignment(S, T, seg["transcript"],
                        origin_start=seg["origin_start"],
                        mutate_start=seg["mutate_start"])
        assert aln.calculate_score(UNIT, -3.0, -1.0) == seg["score"]


def _ref_extend(S, T, segments):
    return sorted(ref_pipeline.extend_segments(
        S, T, segments, use_pallas=True, _interpret=True, _r_chunk=16,
        with_transcripts=True, **EKW), key=lambda s: -s["score"])


def test_fasta_to_transcripts(tmp_path, rng):
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.03, ge_prob=0.1,
                        rng=rng)
    core = rand_seq(A4, 600, rng=rng)
    S = rand_seq(A4, 300, rng=rng) + core + rand_seq(A4, 300, rng=rng)
    T = rand_seq(A4, 500, rng=rng) + M.mutate(core)[0] \
        + rand_seq(A4, 100, rng=rng)
    fa = str(tmp_path / "pair.fa")
    write_fasta(fa, [NamedSequence(P4, from_reference(x).to_array(), name=n)
                     for n, x in (("S", S), ("T", T))], width=60)

    # the port's story: a KmerIndex subscribes through the event hook
    db = DB(str(tmp_path / "meta.db"), P4)
    idx = KmerIndex(8, P4, path=str(tmp_path / "kmers"), device="cpu")
    idx.attach_to(db)
    recs = db.load_fasta(fa)
    assert [r.attrs["name"] for r in recs] == ["S", "T"]
    idx.refresh()
    assert idx.num_seqs == 2 and idx.num_kmers == len(S) + len(T) - 14
    S2, T2 = db.load_from_record(recs[0]), db.load_from_record(recs[1])
    assert str(S2) == str(S) and str(T2) == str(T)
    got = pipeline.discover_and_extend(
        S2, T2, wordlen=8, K_min=250, p_min=0.6, with_transcripts=True,
        device="cpu", **EKW)

    # the JAX package's story on the same file
    ref_db = RefDB(str(tmp_path / "ref.db"), A4)
    ref_idx = RefKmerIndex(8, A4).attach_to(ref_db)
    ref_recs = ref_db.load_fasta(fa)
    ref_idx.refresh()
    assert [(r.content_id, r.source_pos, r.attrs) for r in recs] == \
        [(r.content_id, r.source_pos, r.attrs) for r in ref_recs]
    for g, w in zip(idx.table(), ref_idx.table()):
        assert np.array_equal(g.numpy(), np.asarray(w))
    segments = list(WordBlot(S, T, wordlen=8, g_max=0.2).similar_segments(
        K_min=250, p_min=0.6))
    want = _ref_extend(S, T, segments)
    assert got and _key(got) == _key(want)
    np.testing.assert_allclose([s["p"] for s in got], [s["p"] for s in want],
                               rtol=1e-5, atol=1e-6)
    best = got[0]
    assert best["score"] > 250 and len(best["transcript"]) > 450
    _rescores(S2, T2, got)


def test_reads_mapped_to_a_reference(tmp_path):
    """The mapping story at a small size: reads of a reference's loci
    (10% errors) mapped by ``WordBlotLocalRef`` in one batch, each top
    segment extended with a transcript; the port equals the JAX package
    read by read, and every read lands on its locus."""
    rng = np.random.default_rng(70)
    ref_seq = rand_seq(A4, 20_000, rng=rng)
    M = MutationProcess(A4, subst_probs=0.06, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    loci = rng.integers(0, len(ref_seq) - 800, 3)
    reads = [RefNamedSequence(A4, M.mutate(ref_seq[int(r0):int(r0) + 800])[0]
                              .to_array(), name="read%d" % k)
             for k, r0 in enumerate(loci)]
    write_fasta(str(tmp_path / "ref.fa"),
                [NamedSequence(P4, from_reference(ref_seq).to_array(),
                               name="chr")])
    write_fasta(str(tmp_path / "reads.fa"), [from_reference(r) for r in reads])
    db = DB(str(tmp_path / "map.db"), P4)
    (ref_rec,) = db.load_fasta(str(tmp_path / "ref.fa"))
    idx = KmerIndex(8, P4, device="cpu").attach_to(db)
    read_recs = db.load_fasta(str(tmp_path / "reads.fa"))
    idx.refresh()
    assert idx.num_seqs == len(reads)
    R = db.load_from_record(ref_rec)
    queries = [db.load_from_record(r) for r in read_recs]
    mapper = blot.WordBlotLocalRef(R, wordlen=10, g_max=0.25, device="cpu")
    batch = mapper.similar_segments_batch(queries, K_min=300, p_min=0.5)
    ref_mapper = WordBlotLocalRef(ref_seq, wordlen=10, g_max=0.25)
    want_batch = ref_mapper.similar_segments_batch(reads, K_min=300,
                                                   p_min=0.5)
    for k, (q, r, r0, segs, want_segs) in enumerate(zip(
            queries, reads, loci, batch, want_batch)):
        assert [(s["segment"], s["num_seeds"]) for s in segs] == \
            [(s["segment"], s["num_seeds"]) for s in want_segs]
        top = max(segs, key=lambda s: s["num_seeds"])
        d_lo, d_hi = top["segment"][0]
        assert d_lo - 200 <= -int(r0) <= d_hi + 200
        got = pipeline.extend_segments(q, R, [top], with_transcripts=True,
                                       device="cpu", **EKW)
        assert len(got[0]["transcript"]) > 650
        _rescores(q, R, got)
        if k == 0:
            # one read against the JAX package's extension (each read's
            # shapes cost the interpret-mode kernels a compile)
            assert _key(got) == _key(_ref_extend(r, ref_seq, [top]))
