"""The mapping cells (``map2f.serial``, ``map2f.batch100``) on the CPU at a
small size: the plain mapping reference against the dense Word-Blot
reference where the grid fits, a sound run of each cell correct, a run
whose timed path is broken underneath not correct, and the control (the
reference in bfloat16) not correct."""

import numpy as np
import pytest

from harness import core, generate
from reference import blot as refblot, mapping

CELLS = {"map2f.serial": dict(reads_per_call=1, pool=2),
         "map2f.batch100": dict(reads_per_call=3, pool=1)}


def small_config(**kw):
    """The configuration at a 30 kbp reference, reads of 1200 letters,
    word 10 and K_min 400."""
    cfg = core.read_json("configs", "map2f")
    cfg.update(size=30_000, read_len=1200)
    cfg["mapper"] = dict(cfg["mapper"], wordlen=10)
    cfg["query"] = dict(cfg["query"], K_min=400)
    cfg.update(kw)
    return cfg


def run(cell, fault=None, monkeypatch=None):
    from biseqt_tpu_torch import pipeline

    if fault is not None:
        real = pipeline.map_reads
        monkeypatch.setattr(pipeline, "map_reads",
                            lambda *a, **kw: fault(real(*a, **kw)))
    bench = core.benchmark()
    traffic = core.read_json("traffic", core.cell_of(bench, cell)["traffic"])
    traffic.update(CELLS[cell], trace_calls=1)
    return core.run_cell(bench, cell, 2 ** 31 + 23, 0.0, False, "cpu", 0.0,
                         config=small_config(), traffic=traffic)


@pytest.mark.parametrize("assembler", ["dense", "sparse"])
def test_mapping_reference_equals_the_blot_reference(assembler):
    """Where the dense grid fits, the mapping reference's segments are
    the dense Word-Blot reference's, field for field; with the grid
    refused (the sparse assembly) the same reads still find their loci."""
    cfg = small_config()
    ref, reads, loci = core.load("entries", "map_reads").mapped_reads(
        5, cfg, 4)
    w, g_max = cfg["mapper"]["wordlen"], cfg["mapper"]["g_max"]
    table = mapping.RefTable(ref, w, 4)
    for read, r0 in zip(reads, loci):
        if assembler == "dense":
            got = mapping.similar_segments(read, table, g_max, **cfg["query"])
            assert got == refblot.similar_segments(read, ref, w, 4, g_max,
                                                   **cfg["query"])
        else:
            got = mapping.similar_segments(read, table, g_max,
                                           max_grid_cells=0, **cfg["query"])
        (d_lo, d_hi), _ = got[mapping.best(got)]["segment"]
        assert d_lo <= -r0 <= d_hi


def test_table_serves_every_seed():
    """The table's seeds are the pairwise reference's, in its order."""
    rng = np.random.default_rng(6)
    ref = rng.integers(0, 4, 5000).astype(np.int8)
    read = generate.channel(rng, ref[1000:2500], 0.06, 0.02, 0.05)
    got = mapping.RefTable(ref, 8, 4).seeds(read)
    want = refblot.seeds(read, ref, 8, 4)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    result, checks = run(cell)
    assert result["correct"] and result["failed"] == 0
    assert checks["exact_diff"] == (0, 0) and checks["ref_gap"] == (0.0, 0.0)
    assert 0.0 <= checks["stat_gap"][0] < 1e-3


def drop_row(out):
    out[0]["rows"] = []
    return out


def alter_score(out):
    out[0]["rows"][0]["score"] += 1.0
    return out


def change_best(out):
    o = out[0]
    n = len(o["segments"])
    o["best"] = None if n < 2 else (o["best"] + 1) % n
    return out


@pytest.mark.parametrize("fault", [drop_row, alter_score, change_best],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    result, checks = run("map2f.batch100", fault, monkeypatch)
    assert not result["correct"] and result["failed"] == result["attempted"]
    if fault is change_best:
        assert checks["exact_diff"][0] > 0
    else:
        assert checks["ref_gap"][0] > 0


def test_control_fails_the_check():
    """The reference in bfloat16 in the program's place fails a limit."""
    cfg = small_config()
    traffic = core.read_json("traffic", "batch100")
    traffic.update(CELLS["map2f.batch100"])
    entry = core.load("entries", "map_reads").Entry(cfg, traffic, 7, "cpu")
    got = entry.control("cpu")
    assert got["ref_gap"] > 0 or got["exact_diff"] > 0 or \
        got["stat_gap"] > cfg["limits"]["stat_gap"]
