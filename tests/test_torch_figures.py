"""The port's figure layer (biseqt_tpu_torch.experiments.figures) against
the JAX package's ``experiments/figures.py``.

Every plotter indexes harness rows by string key, so the port's rows
and the JAX package's dumps must both render: synthetic rows, the
port's own rows and a JAX script's rows each go through the port's
plotter and leave a PNG.  Without matplotlib every plotter returns
None, as the JAX package's do.
"""

import os
import pickle
import sys

import pytest

from biseqt_tpu_torch.experiments import (band_radius_stats, figures,
                                          overlap_recall, util,
                                          wordblot_recall)

_EXP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments",
)
sys.path.insert(0, _EXP)

import band_radius_stats as jax_band  # noqa: E402
import figures as jax_figures  # noqa: E402

needs_mpl = pytest.mark.skipif(not util.HAVE_MPL,
                               reason="matplotlib unavailable")

SYNTHETIC = {
    "plot_band_radius": [
        {"g": g, "K": K, "containment_endpoint": 0.95,
         "containment_sup": 0.9, "target_endpoint": 0.95,
         "target_sup_approx": 0.9}
        for g in (0.05, 0.15) for K in (100, 1000, 10000)],
    "plot_wordblot_recall": [
        {"p_min": p, "recall_at_k": 1.0, "precision": 1.0,
         "p_hat_mae": 0.05 if p < 0.8 else None}
        for p in (0.5, 0.6, 0.7, 0.8)]
    + [{"index_memory": 123456, "seq_len": 100000}],
    "plot_overlap_pr": [
        {"err": e, "precision": 0.999 if e < 0.15 else None,
         "recall": 0.999, "n_reads": 1000} for e in (0.10, 0.12, 0.15)],
    "plot_genome_phases": [
        {"pass": name, "t_index": 6.9, "t_discover": 8.7, "t_extend": 7.6,
         "extend_gcups": 0.76, "block_recall": 1.0, "size": 5_000_000}
        for name in ("cold", "warm")],
}


def _check(path):
    assert path is not None
    assert os.path.exists(path)
    assert os.path.getsize(path) > 0


@needs_mpl
@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_plotter_renders_synthetic_rows(name, tmp_path):
    _check(getattr(figures, name)(SYNTHETIC[name],
                                  out=str(tmp_path / (name + ".png"))))


def test_plotters_are_the_jax_packages():
    names = sorted(n for n in dir(jax_figures) if n.startswith("plot_"))
    assert names == sorted(n for n in dir(figures) if n.startswith("plot_"))
    assert names == sorted(SYNTHETIC)


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_plotter_without_matplotlib_returns_none(name, monkeypatch,
                                                 tmp_path, capsys):
    monkeypatch.setattr(figures, "HAVE_MPL", False)
    out = str(tmp_path / "none.png")
    assert getattr(figures, name)(SYNTHETIC[name], out=out) is None
    assert not os.path.exists(out)
    assert "matplotlib unavailable" in capsys.readouterr().err


@needs_mpl
def test_ports_rows_render(tmp_path):
    """The port's own rows, computed on the CPU at a small size."""
    _check(figures.plot_band_radius(
        band_radius_stats.run(Ks=(100, 400), gs=(0.05,), n_trials=5),
        out=str(tmp_path / "band.png")))
    _check(figures.plot_wordblot_recall(
        wordblot_recall.run_sweep(device="cpu", **wordblot_recall.QUICK),
        out=str(tmp_path / "recall.png")))
    rows = [overlap_recall.run(err=err, device="cpu", **overlap_recall.QUICK)
            for err in (0.10, 0.15)]
    _check(figures.plot_overlap_pr(rows, out=str(tmp_path / "pr.png")))


@needs_mpl
def test_jax_dump_renders(tmp_path):
    """A dump the JAX script wrote (``with_dumpfile``) is read back by
    the port's ``with_dumpfile`` without recomputing and plotted."""
    dump = str(tmp_path / "band.pkl")
    want = jax_band.run(Ks=(100,), gs=(0.05, 0.3), n_trials=4,
                        dumpfile=dump)
    with open(dump, "rb") as f:
        assert pickle.load(f) == want
    rows = band_radius_stats.run(Ks=(999,), dumpfile=dump)
    assert rows == want
    _check(figures.plot_band_radius(rows, out=str(tmp_path / "band.png")))
