"""Paper-figure rendering for the experiment harnesses: the port's copy
of ``experiments/figures.py``.

Every plotter takes the ROWS a harness already computes (and caches via
``with_dumpfile``) and writes a PNG, so no card time is spent re-running
a sweep to redraw it.  The rows' keys are the JAX package's, so either
package's dumps render here.

All plotters degrade gracefully (warn + return None) when matplotlib is
absent.  Each harness exposes them behind ``--plot [PATH.png]``.
"""

import sys

import numpy as np

from .util import HAVE_MPL, plt, savefig


def _no_mpl(name):
    print("figures: matplotlib unavailable, skipping %s" % name,
          file=sys.stderr)
    return None


def plot_band_radius(rows, out="band_radius.png"):
    """Containment curves vs K per gap probability (config: band-radius
    model validation).  Solid: endpoint containment vs its target
    (dashed); dotted: sup-containment vs the reflection-principle
    approximation."""
    if not HAVE_MPL:
        return _no_mpl(out)
    gs = sorted({r["g"] for r in rows})
    fig, ax = plt.subplots(figsize=(6, 4))
    for g in gs:
        sub = sorted((r for r in rows if r["g"] == g), key=lambda r: r["K"])
        Ks = [r["K"] for r in sub]
        ax.plot(Ks, [r["containment_endpoint"] for r in sub], "o-",
                label="g=%.2f endpoint" % g)
        ax.plot(Ks, [r["containment_sup"] for r in sub], "s:",
                label="g=%.2f sup" % g)
    ax.axhline(rows[0]["target_endpoint"], color="k", ls="--", lw=0.8,
               label="target (endpoint)")
    ax.axhline(rows[0]["target_sup_approx"], color="k", ls=":", lw=0.8,
               label="target (sup approx)")
    ax.set_xscale("log")
    ax.set_xlabel("alignment length K")
    ax.set_ylabel("fraction of paths contained in band")
    ax.set_ylim(0.5, 1.02)
    ax.set_title("band_radius(K, g) containment (sqrt(gK) model)")
    ax.legend(fontsize=7)
    savefig(fig, out)
    return out


def plot_wordblot_recall(rows, out="wordblot_recall.png"):
    """Recall@k / precision / p-hat MAE vs p_min (BASELINE config 2)."""
    if not HAVE_MPL:
        return _no_mpl(out)
    sweep = [r for r in rows if "p_min" in r]
    meta = next((r for r in rows if "index_memory" in r), None)
    xs = [r["p_min"] for r in sweep]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(xs, [r["recall_at_k"] for r in sweep], "o-", label="recall@k")
    ax.plot(xs, [r["precision"] for r in sweep], "s-", label="precision")
    mae = [(r["p_hat_mae"] if r["p_hat_mae"] is not None else np.nan)
           for r in sweep]
    ax.plot(xs, mae, "^--", label="p-hat MAE")
    ax.set_xlabel("p_min threshold")
    ax.set_ylabel("recall@k / precision / MAE")
    ax.set_ylim(-0.02, 1.05)
    title = "Word-Blot planted-segment recovery"
    if meta:
        title += " (%d kbp pairs)" % (meta["seq_len"] // 1000)
    ax.set_title(title)
    ax.legend()
    savefig(fig, out)
    return out


def plot_overlap_pr(rows, out="overlap_pr.png"):
    """Precision/recall vs read error rate (BASELINE config 4 sweep)."""
    if not HAVE_MPL:
        return _no_mpl(out)
    rows = sorted(rows, key=lambda r: r["err"])
    errs = [100 * r["err"] for r in rows]
    x = np.arange(len(errs))
    fig, ax = plt.subplots(figsize=(6, 4))
    w = 0.35
    prec = [(r["precision"] if r["precision"] is not None else 0.0)
            for r in rows]
    ax.bar(x - w / 2, prec, w, label="precision")
    ax.bar(x + w / 2, [r["recall"] for r in rows], w, label="recall")
    ax.set_xticks(x, ["%g%%" % e for e in errs])
    ax.set_xlabel("simulated read error rate")
    ax.set_ylabel("precision / recall")
    ax.set_ylim(0, 1.05)
    ax.axhline(1.0, color="k", lw=0.5, ls=":")
    ax.set_title("all-vs-all overlap detection (%d reads)"
                 % rows[0]["n_reads"])
    ax.legend(loc="lower left")
    savefig(fig, out)
    return out


def plot_genome_phases(rows, out="genome_phases.png"):
    """Per-phase wall-clock bars + extension GCUPS (BASELINE config 5).

    ``rows``: run_once dicts (e.g. cold + warm passes)."""
    if not HAVE_MPL:
        return _no_mpl(out)
    phases = ["t_index", "t_discover", "t_extend"]
    labels = [r.get("pass", "run %d" % k) for k, r in enumerate(rows)]
    x = np.arange(len(rows))
    fig, ax = plt.subplots(figsize=(6, 4))
    bottom = np.zeros(len(rows))
    for ph in phases:
        vals = np.asarray([r[ph] for r in rows], float)
        ax.bar(x, vals, 0.55, bottom=bottom, label=ph[2:])
        bottom += vals
    for k, r in enumerate(rows):
        ax.text(x[k], bottom[k] + 0.02 * bottom.max(),
                "%.1f GCUPS\nrecall %.2f" % (
                    r["extend_gcups"], r["block_recall"]),
                ha="center", fontsize=8)
    ax.set_xticks(x, labels)
    ax.set_ylabel("wall-clock (s)")
    ax.set_title("genome homology phases (2 x %d Mbp)"
                 % (rows[0]["size"] // 1_000_000))
    ax.legend()
    savefig(fig, out)
    return out
