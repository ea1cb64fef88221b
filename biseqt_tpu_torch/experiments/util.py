"""Experiment utilities: the port's copy of ``experiments/util.py``.

Re-exports the result-caching decorator, the progress indicator and the
wall timer of :mod:`biseqt_tpu_torch.utils`, and provides plotting
helpers that degrade gracefully when matplotlib is absent.
"""

import numpy as np

from ..utils import ProgressIndicator, Timer, with_dumpfile  # noqa: F401

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAVE_MPL = True
except ImportError:  # pragma: no cover
    plt = None
    HAVE_MPL = False


def plot_with_sd(ax, xs, ys_runs, label=None, **kw):
    """Plot mean ± sd across runs (axis 0 of ys_runs)."""
    ys = np.asarray(ys_runs, float)
    mean = ys.mean(axis=0)
    sd = ys.std(axis=0)
    ax.plot(xs, mean, label=label, **kw)
    ax.fill_between(xs, mean - sd, mean + sd, alpha=0.2)


def savefig(fig, path):
    if HAVE_MPL:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        print("wrote", path)
