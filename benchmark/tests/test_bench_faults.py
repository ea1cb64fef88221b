"""A run whose timed path is broken underneath comes out not correct,
and so does the control (the reference in bfloat16 in the program's
place).  The harness's look for a card is skipped: the program runs its
CPU twins at a small size."""

import pytest
import torch

import tiny
from harness import core


def run(monkeypatch, fault=None, device="cpu"):
    from biseqt_tpu_torch import pipeline

    if fault is not None:
        real = pipeline.extend_segments
        monkeypatch.setattr(pipeline, "extend_segments",
                            lambda *a, **kw: fault(real(*a, **kw)))
    result, checks = core.run_cell(
        core.benchmark(), "tx1t.b16", 4_000_000_007, 0.0, False, device,
        0.0, config=tiny.config(), traffic=tiny.traffic())
    return result, checks


def drop_half(rows):
    return rows[: len(rows) // 2]


def alter_score(rows):
    rows[1]["score"] += 1.0
    return rows


def alter_transcript(rows):
    tx = rows[0]["transcript"]
    k = tx.index("M")
    rows[0]["transcript"] = tx[:k] + "S" + tx[k + 1:]
    return rows


def test_sound_run_is_correct(monkeypatch):
    result, checks = run(monkeypatch)
    assert result["correct"] and checks["ref_gap"] == (0.0, 0.0)
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", [drop_half, alter_score, alter_transcript],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    result, checks = run(monkeypatch, fault)
    assert not result["correct"]
    assert checks["ref_gap"][0] > checks["ref_gap"][1]
    assert result["failed"] == result["attempted"]


def test_control_fails_the_check():
    entry = core.load("entries", "extend_segments").Entry(
        tiny.config(block=2000, indel_margin=100), tiny.traffic(), 5, "cpu")
    assert entry.control("cpu")["ref_gap"] > 0.0


@pytest.mark.cuda
def test_control_fails_the_check_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    entry = core.load("entries", "extend_segments").Entry(
        tiny.config(block=2000, indel_margin=100), tiny.traffic(), 5, "cuda")
    assert entry.control("cuda")["ref_gap"] > 0.0
    done = [(k, entry.call(k)) for k in range(len(entry))]
    assert entry.judge(done, device="cuda") == ({"ref_gap": (0.0, 0.0)}, 0)


def run_genome(monkeypatch, cell, config, where=None, fault=None):
    if fault is not None:
        module, name = where
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, **kw: fault(real(*a, **kw)))
    bench = core.benchmark()
    traffic = core.read_json("traffic", core.cell_of(bench, cell)["traffic"])
    return core.run_cell(bench, cell, 2 ** 33 + 1, 0.0, False, "cpu", 0.0,
                         config=config, traffic=traffic)


def drop_segment(segs):
    return segs[1:]


def alter_seed_count(segs):
    segs[0]["num_seeds"] += 1
    return segs


def alter_stat(segs):
    segs[0]["score"] = (segs[0]["score"][0], segs[0]["score"][1] * 1.5)
    return segs


@pytest.mark.parametrize("fault", [None, drop_segment, alter_seed_count,
                                   alter_stat],
                         ids=lambda f: getattr(f, "__name__", "sound"))
def test_discovery_faults(monkeypatch, fault):
    from biseqt_tpu_torch import blot

    def broken(self, *a, **kw):
        return iter(fault(list(real(self, *a, **kw))))

    if fault is not None:
        real = blot.WordBlot.similar_segments
        monkeypatch.setattr(blot.WordBlot, "similar_segments", broken)
    result, checks = run_genome(monkeypatch, "genome5t.discover",
                                tiny.genome(400_000, 4))
    assert result["correct"] == (fault is None)
    assert (checks["exact_diff"][0] > 0 or checks["stat_gap"][0]
            > checks["stat_gap"][1]) == (fault is not None)


def test_discovery_control_fails_the_check():
    entry = core.load("entries", "wordblot").Entry(
        tiny.genome(400_000, 4), {}, 3, "cpu")
    readings = entry.control("cpu")
    assert readings["stat_gap"] > entry.config["limits"]["stat_gap"]


def test_genome_extension_sound_and_broken(monkeypatch):
    from biseqt_tpu_torch import pipeline

    result, checks = run_genome(monkeypatch, "genome5t.tx", tiny.genome())
    assert result["correct"]
    assert checks["ref_gap"] == (0.0, 0.0) and checks["exact_diff"][0] == 0
    result, checks = run_genome(monkeypatch, "genome5t.tx", tiny.genome(),
                                (pipeline, "discover_and_extend"),
                                lambda rows: rows[: len(rows) // 2])
    assert not result["correct"] and checks["ref_gap"][0] > 0
