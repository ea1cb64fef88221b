"""The port's entry points default to the card, and the port keeps its
own sources.

* Every public entry point takes ``device="cuda"`` by default.  Called
  without ``device`` where no card is present it raises a RuntimeError
  that says so and launches nothing; with ``device="cpu"`` the same
  call runs its plain PyTorch version.
* The C++ host tier builds from the port's own copy of
  ``pwnative.cpp``, byte for byte the JAX package's (a drift guard).
* No module of the port imports the JAX package or names a path under
  ``biseqt_tpu/``.
"""

import ast
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from biseqt_tpu_torch import (blot, kmers, native, pipeline, protein, pw,
                              seeds, stochastics)
from biseqt_tpu_torch.experiments import (adkernel_probe, fixed_ref_bench,
                                          genome_homology, i16_probe,
                                          index_build_bench,
                                          multiple_homology, overlap_recall,
                                          pipeline_tx_probe, protein_search,
                                          transpose_probe, txpath_probe,
                                          walk_probe, wordblot_recall)
from biseqt_tpu_torch.ops import (allvsall_sorted, banded_dp, blot_stats,
                                  dp_ad, dp_row, tables, walk)
from biseqt_tpu_torch.parallel import (allvsall, mesh, sharded_dp,
                                       sharded_dp_ad, sweep)
from biseqt_tpu_torch.sequence import Alphabet, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "biseqt_tpu_torch")

UNIT = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
LAUNCH_COUNTERS = (dp_ad, dp_row, walk, transpose_probe, i16_probe)


def _pairs():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, (2, 40)).astype(np.int8)
    lens = np.full(2, 40, np.int32)
    return s, s.copy(), lens, lens


def _dp_kw():
    return dict(subst=UNIT, go=-2.0, ge=-1.0,
                flags=banded_dp.ModeFlags(local_start=True, local_end=True))


def _extend(**kw):
    A4 = Alphabet("ACGT")
    S = Sequence(A4, np.random.default_rng(4).integers(0, 4, 200))
    return pipeline.extend_segments(
        S, S, [{"segment": ((-8, 8), (20, 300))}], **kw)


def _aligner(**kw):
    A4 = Alphabet("ACGT")
    S = Sequence(A4, np.random.default_rng(5).integers(0, 4, 60))
    with pw.Aligner(S, S, **kw) as aln:
        return aln.solve()


def _walk(fn, **kw):
    zeros = np.zeros(2, np.int32)
    return fn(torch.zeros((8, 1, 128), dtype=torch.uint8), zeros, zeros,
              zeros, W=128, **kw)


def _full_traceback(**kw):
    return banded_dp.full_dp_traceback(*_pairs(), end_i=[40, 40],
                                       end_j=[40, 40], **_dp_kw(), **kw)


def _pair_seqs():
    A4 = Alphabet("ACGT")
    rng = np.random.default_rng(6)
    S = Sequence(A4, rng.integers(0, 4, 300))
    return S, S[40:260]


def _local_ref(**kw):
    S, T = _pair_seqs()
    return list(blot.WordBlotLocalRef(S, **kw).similar_segments_batch(
        [T], K_min=50, p_min=0.5))


def _overlap_ref(**kw):
    S, T = _pair_seqs()
    return blot.WordBlotOverlapRef(S, **kw).highest_scoring_overlap_band(T)


def _nway_seqs():
    S, T = _pair_seqs()
    return S, T, S[100:280]


def _discover(**kw):
    return pipeline.discover_and_extend(*_pair_seqs(), K_min=50, p_min=0.5,
                                        **kw)


_CODES = np.random.default_rng(7).integers(0, 4, (2, 30)).astype(np.int8)
_LENS = np.asarray([30, 25], np.int32)
_TABLE_CALLS = {
    "kmer_keys": lambda **kw: tables.kmer_keys(_CODES, _LENS, 4, **kw),
    "build_kmer_table": lambda **kw: tables.build_kmer_table(
        _CODES, _LENS, 4, **kw),
    "nway_shared_seeds": lambda **kw: tables.nway_shared_seeds(
        _CODES, _LENS, 4, **kw),
    "hit_ranges": lambda **kw: tables.hit_ranges(
        np.arange(5, dtype=np.int32), np.arange(3, dtype=np.int32), **kw),
    "expand_join": lambda **kw: tables.expand_join(
        np.zeros(3, np.int32), np.ones(3, np.int32), **kw),
    "seed_total": lambda **kw: tables.seed_total(
        _CODES[0], 30, _CODES[1], 25, 4, **kw),
    "seed_join": lambda **kw: tables.seed_join(
        _CODES[0], 30, _CODES[1], 25, 4, **kw),
    "seed_join_sorted": lambda **kw: tables.seed_join_sorted(
        _CODES[0], 30, _CODES[1], 25, 4, **kw),
    "run_boundaries": lambda **kw: tables.run_boundaries(
        np.arange(4, dtype=np.int32), **kw),
}
_STATS_CALLS = {
    "grid_counts": lambda **kw: blot_stats.grid_counts(
        np.zeros(3, np.int32), np.ones(3, np.int32), 2, 2, **kw),
    "box_sum3": lambda **kw: blot_stats.box_sum3(
        np.ones((3, 3), np.int32), **kw),
    "sliding_band_sums": lambda **kw: blot_stats.sliding_band_sums(
        np.ones(9, np.int32), 2, **kw),
    "h0_h1_scores": lambda **kw: blot_stats.h0_h1_scores(
        5.0, 100.0, 10.0, 0.8, 8, **kw),
    "estimate_match_probability": lambda **kw:
        blot_stats.estimate_match_probability(5.0, 10.0, 8, **kw),
}


ENTRY_POINTS = {
    "extend_segments": (pipeline.extend_segments, _extend),
    "discover_and_extend": (pipeline.discover_and_extend, _discover),
    "WordBlot": (blot.WordBlot, lambda **kw: list(blot.WordBlot(
        *_pair_seqs(), **kw).similar_segments(K_min=50, p_min=0.5))),
    "WordBlotOverlap": (
        blot.WordBlotOverlap, lambda **kw: blot.WordBlotOverlap(
            *_pair_seqs(), **kw).highest_scoring_overlap_band()),
    "SeedIndex": (seeds.SeedIndex, lambda **kw: seeds.SeedIndex(
        *_pair_seqs(), 8, **kw)),
    "KmerIndex": (kmers.KmerIndex, lambda **kw: kmers.KmerIndex(
        8, Alphabet("ACGT"), **kw).index_kmers(_pair_seqs()).score_kmers()),
    "WordBlotLocalRef": (blot.WordBlotLocalRef, _local_ref),
    "WordBlotOverlapRef": (blot.WordBlotOverlapRef, _overlap_ref),
    "SeedIndexMultiple": (seeds.SeedIndexMultiple,
                          lambda **kw: seeds.SeedIndexMultiple(
                              *_nway_seqs(), **kw)),
    "WordBlotMultiple": (blot.WordBlotMultiple, lambda **kw: list(
        blot.WordBlotMultiple(*_nway_seqs(), **kw).similar_segments(
            K_min=50, p_min=0.5))),
    "Aligner": (pw.Aligner, _aligner),
    "banded_dp_ad": (dp_ad.banded_dp_ad, lambda **kw: dp_ad.banded_dp_ad(
        *_pairs(), [-8, -8], W=128, **_dp_kw(), **kw)),
    "banded_dp_ad_reference": (
        dp_ad.banded_dp_ad_reference,
        lambda **kw: dp_ad.banded_dp_ad_reference(
            *_pairs(), [-8, -8], W=128, **_dp_kw(), **kw)),
    "banded_dp_row": (dp_row.banded_dp_row, lambda **kw: dp_row.banded_dp_row(
        *_pairs(), [-8, -8], W=128, **_dp_kw(), **kw)),
    "banded_dp_row_reference": (
        dp_row.banded_dp_row_reference,
        lambda **kw: dp_row.banded_dp_row_reference(
            *_pairs(), [-8, -8], W=128, **_dp_kw(), **kw)),
    "traceback_walk": (walk.traceback_walk,
                       lambda **kw: _walk(walk.traceback_walk, **kw)),
    "traceback_walk_reference": (
        walk.traceback_walk_reference,
        lambda **kw: _walk(walk.traceback_walk_reference, **kw)),
    "banded_dp": (banded_dp.banded_dp, lambda **kw: banded_dp.banded_dp(
        *_pairs(), [-8, -8], W=17, **_dp_kw(), **kw)),
    "full_dp": (banded_dp.full_dp, lambda **kw: banded_dp.full_dp(
        *_pairs(), **_dp_kw(), **kw)),
    "full_dp_traceback": (banded_dp.full_dp_traceback, _full_traceback),
    "transpose_minor": (
        transpose_probe.transpose_minor,
        lambda **kw: transpose_probe.transpose_minor(
            np.zeros((2, 3, 4), np.uint8), **kw)),
    "transpose_minor_reference": (
        transpose_probe.transpose_minor_reference,
        lambda **kw: transpose_probe.transpose_minor_reference(
            np.zeros((2, 3, 4), np.uint8), **kw)),
    "i16_op": (i16_probe.i16_op, lambda **kw: i16_probe.i16_op(
        "add", np.zeros((2, 128), np.int16), **kw)),
    "i16_op_reference": (
        i16_probe.i16_op_reference,
        lambda **kw: i16_probe.i16_op_reference(
            "add", np.zeros((2, 128), np.int16), **kw)),
}
_NULL_MODEL_CALLS = {
    "binomial_to_normal": lambda **kw: stochastics.binomial_to_normal(
        [100.0, 9600.0], 0.25, **kw),
    "np_log_erfc": lambda **kw: stochastics.np_log_erfc([0.5, 4.0], **kw),
    "normal_neg_log_pvalue": lambda **kw: stochastics.normal_neg_log_pvalue(
        [25.0, 0.0], [4.3, 0.0], [40.0, 1.0], **kw),
}
_READS = np.random.default_rng(8).integers(0, 4, (4, 60)).astype(np.int8)
_READ_LENS = np.asarray([60, 60, 50, 40], np.int32)
_PROTEIN = np.random.default_rng(9).integers(0, 20, (2, 40)).astype(np.int8)
_BATCH_CALLS = {
    "rand_seq_batch": lambda **kw: stochastics.rand_seq_batch(
        torch.Generator(), 2, 10, **kw),
    "mutate_batch": lambda **kw: stochastics.mutate_batch(
        torch.Generator(), _CODES, _LENS, 0.1, 0.05, 0.2, **kw),
    "batch_mutation_draws": lambda **kw: stochastics.batch_mutation_draws(
        torch.Generator(), 2, 30, 0.1, 0.05, 0.2, **kw),
    "apply_batch_mutations": lambda **kw: stochastics.apply_batch_mutations(
        _CODES, _LENS, stochastics.batch_mutation_draws(
            torch.Generator(), 2, 30, 0.1, 0.05, 0.2, device="cpu"), 0.2,
        **kw),
}
def _sweep(**kw):
    import tempfile

    with tempfile.TemporaryDirectory() as out_dir:
        return sweep.checkpointed_overlap_sweep(_READS, _READ_LENS, out_dir,
                                                wordlen=4, block=2, **kw)


_OVERLAP_CALLS = {
    "overlap_stats_sorted": (allvsall_sorted, lambda **kw:
                             allvsall_sorted.overlap_stats_sorted(
                                 _READS, _READ_LENS, wordlen=4, n_reads=4,
                                 **kw)),
    "overlap_stats_sorted_chunked": (
        allvsall_sorted, lambda **kw:
        allvsall_sorted.overlap_stats_sorted_chunked(
            _READS, _READ_LENS, wordlen=4, n_reads=4, max_chunk=3, **kw)),
    "make_mesh": (mesh, lambda **kw: mesh.make_mesh(**kw)),
    "overlap_stats_block": (allvsall, lambda **kw:
                            allvsall.overlap_stats_block(
                                _READS, _READ_LENS, _READS, _READ_LENS,
                                wordlen=4, **kw)),
    "overlap_matrix_sharded": (allvsall, lambda **kw:
                               allvsall.overlap_matrix_sharded(
                                   _READS, _READ_LENS, wordlen=4, **kw)),
    "overlap_matrix_sorted_sharded": (
        allvsall, lambda **kw: allvsall.overlap_matrix_sorted_sharded(
            _READS, _READ_LENS, wordlen=4, **kw)),
    "all_vs_all_overlaps": (allvsall, lambda **kw:
                            allvsall.all_vs_all_overlaps(
                                _READS, _READ_LENS, wordlen=4, **kw)),
    "banded_dp_band_sharded": (sharded_dp, lambda **kw:
                               sharded_dp.banded_dp_band_sharded(
                                   *_pairs(), [-8, -8], W=32, **_dp_kw(),
                                   **kw)),
    "banded_dp_band_sharded_ad": (sharded_dp_ad, lambda **kw:
                                  sharded_dp_ad.banded_dp_band_sharded_ad(
                                      *_pairs(), [-8, -8], W=32, halo=8,
                                      **_dp_kw(), **kw)),
    "band_sharded_ad_traceback": (sharded_dp_ad, lambda **kw:
                                  sharded_dp_ad.band_sharded_ad_traceback(
                                      *_pairs(), [-8, -8], W=32, halo=8,
                                      ckpt_chunks=2, **_dp_kw(), **kw)),
    "checkpointed_overlap_sweep": (sweep, _sweep),
    "two_tier_scores": (protein, lambda **kw: protein.two_tier_scores(
        _PROTEIN, _PROTEIN, [40, 40], [40, 40], [-8, -8], W=128,
        go=-11.0, ge=-1.0, w_eff=[17, 17], threshold=10.0,
        flags=banded_dp.ModeFlags(local_start=True, local_end=True),
        **kw)),
}
# the experiments, each at a tiny size
_EXPERIMENT_CALLS = {
    "wordblot_recall.run_sweep": (wordblot_recall.run_sweep, lambda **kw:
                                  wordblot_recall.run_sweep(
                                      seq_len=3000, n_segments=2,
                                      seg_len=400, n_trials=1, K_min=200,
                                      p_mins=(0.6,), **kw)),
    "multiple_homology.run": (multiple_homology.run, lambda **kw:
                              multiple_homology.run(2, 1000, **kw)),
    "fixed_ref_bench.run": (fixed_ref_bench.run, lambda **kw:
                            fixed_ref_bench.run(
                                ref_len=20_000, n_queries=2, query_len=1000,
                                wordlen=8, K_min=200, **kw)),
    "index_build_bench.run": (index_build_bench.run, lambda **kw:
                              index_build_bench.run(4, 200, **kw)),
    "genome_homology.run_once": (genome_homology.run_once, lambda **kw:
                                 genome_homology.run_once(1, 4000, 2, 8,
                                                          **kw)),
    "overlap_recall.run": (overlap_recall.run, lambda **kw:
                           overlap_recall.run(genome_len=3000, read_len=800,
                                              n_reads=4, **kw)),
    "protein_search.run": (protein_search.run, lambda **kw:
                           protein_search.run(B=16, L=32, n_batches=2,
                                              **kw)),
    # the four path probes
    "pipeline_tx_probe.run": (pipeline_tx_probe.run, lambda **kw:
                              pipeline_tx_probe.run(n=2, core_len=150,
                                                    reps=1, **kw)),
    "walk_probe.run": (walk_probe.run, lambda **kw:
                       walk_probe.run(B=4, L=220, tB=2, tL=300, runs=1,
                                      **kw)),
    "adkernel_probe.run": (adkernel_probe.run, lambda **kw:
                           adkernel_probe.run(B=2, L=300, runs=1, **kw)),
    "txpath_probe.run": (txpath_probe.run, lambda **kw:
                         txpath_probe.run(B=4, L=300, reps=1, **kw)),
}
ENTRY_POINTS.update(_EXPERIMENT_CALLS)
ENTRY_POINTS.update({name: (getattr(stochastics, name), call)
                     for name, call in _NULL_MODEL_CALLS.items()})
ENTRY_POINTS.update({name: (getattr(stochastics, name), call)
                     for name, call in _BATCH_CALLS.items()})
ENTRY_POINTS.update({name: (getattr(module, name), call)
                     for name, (module, call) in _OVERLAP_CALLS.items()})
ENTRY_POINTS.update({name: (getattr(tables, name), call)
                     for name, call in _TABLE_CALLS.items()})
ENTRY_POINTS.update({name: (getattr(blot_stats, name), call)
                     for name, call in _STATS_CALLS.items()})


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    launches = [m.LAUNCHES for m in LAUNCH_COUNTERS]
    with pytest.raises(RuntimeError, match="CUDA card and none is present"):
        call()
    assert [m.LAUNCHES for m in LAUNCH_COUNTERS] == launches
    call(device="cpu")                    # the same call runs on the CPU
    assert [m.LAUNCHES for m in LAUNCH_COUNTERS] == launches


def test_native_source_is_the_ports_own_copy():
    assert os.path.commonpath([native.SOURCE, PORT]) == PORT
    with open(native.SOURCE, "rb") as f:
        ours = f.read()
    with open(os.path.join(REPO, "biseqt_tpu", "native", "pwnative.cpp"),
              "rb") as f:
        assert ours == f.read()


def _port_modules():
    for root, _, files in os.walk(PORT):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def _names_jax_package(text: str) -> bool:
    parts = text.replace("\\", "/").replace(".", "/").split("/")
    return "biseqt_tpu" in parts


def test_port_names_no_path_of_the_jax_package():
    """Imports, and every string other than a docstring (a path join's
    parts, a path literal), in every module of the port."""
    found = []
    for path in _port_modules():
        with open(path) as f:
            tree = ast.parse(f.read())
        docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                      if isinstance(node, (ast.Module, ast.FunctionDef,
                                           ast.ClassDef))
                      and node.body and isinstance(node.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and id(node) not in docstrings):
                names = [node.value]
            else:
                continue
            found += ["%s:%d %r" % (os.path.relpath(path, REPO), node.lineno,
                                    n) for n in names if _names_jax_package(n)]
    assert not found, found
    walked = {os.path.relpath(path, PORT) for path in _port_modules()}
    assert {"utils.py", "kmers.py", "database.py", "blot.py",
            "seeds.py"} <= walked and len(walked) >= 25


_IMPORT_EVERY_MODULE_WITHOUT_JAX = r"""
import importlib, importlib.abc, os, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "biseqt_tpu"):
            raise ImportError("refused: " + name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "biseqt_tpu"):
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())
names = []
for root, _, files in os.walk("biseqt_tpu_torch"):
    for f in sorted(files):
        if f.endswith(".py"):
            mod = os.path.join(root, f)[:-3].replace(os.sep, ".")
            names.append(mod[:-len(".__init__")] if mod.endswith(
                ".__init__") else mod)
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "biseqt_tpu")]
assert not bad, bad
print(len(names), "ok")
"""


def test_every_port_module_imports_without_jax():
    """Every module of the port (the all-vs-all, mesh and protein modules,
    the batch tier and the experiments included) imports in an
    interpreter that refuses jax and the JAX package."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c",
                          _IMPORT_EVERY_MODULE_WITHOUT_JAX], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    count, ok = out.stdout.split()
    assert ok == "ok" and int(count) >= 44
    for module in ("protein", "parallel.mesh", "parallel.allvsall",
                   "parallel.sharded_dp", "parallel.sharded_dp_ad",
                   "parallel.sweep",
                   "ops.allvsall_sorted", "experiments.util",
                   "experiments.figures", "experiments.band_radius_stats",
                   "experiments.wordblot_recall",
                   "experiments.multiple_homology",
                   "experiments.fixed_ref_bench", "experiments.ingest_bench",
                   "experiments.index_build_bench",
                   "experiments.genome_homology",
                   "experiments.overlap_recall",
                   "experiments.protein_search",
                   "experiments.pipeline_tx_probe",
                   "experiments.walk_probe", "experiments.adkernel_probe",
                   "experiments.txpath_probe"):
        assert os.path.exists(os.path.join(
            PORT, module.replace(".", os.sep) + ".py"))
