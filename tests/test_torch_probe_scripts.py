"""The port's four path probes (biseqt_tpu_torch.experiments:
pipeline_tx_probe, walk_probe, adkernel_probe, txpath_probe) on the
CPU, at tiny sizes, against the JAX package's kernels (interpret mode)
and scripts on the same inputs.

Exact: transcripts, scores and start cells equal.  The probes' timings
are host-clock readings of the plain twins here and are not checked.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np

import biseqt_tpu.pipeline as ref_pipeline
from biseqt_tpu import native as ref_native
from biseqt_tpu.ops.banded_dp import ModeFlags as RefFlags
from biseqt_tpu.ops.pallas_dp_ad import (banded_dp_pallas_ad,
                                         parity_adjusted_dmin)
from biseqt_tpu.ops.pallas_walk import traceback_sweep
from biseqt_tpu_torch.experiments import (adkernel_probe, pipeline_tx_probe,
                                          txpath_probe, walk_probe)
from biseqt_tpu_torch.ops.dp_ad import banded_dp_ad

_EXP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments",
)
sys.path.insert(0, _EXP)

import pipeline_tx_probe as jax_ptx  # noqa: E402
import walk_probe as jax_walk  # noqa: E402

LOCAL = RefFlags(local_start=True, local_end=True)


def test_walk_probe_correctness_matches_the_jax_walk():
    """The correctness phase on 8 pairs of up to 260 letters: no
    transcript differs from the host walker's, and the transcripts and
    start cells equal the JAX probe's route on the same inputs (its K1
    and sublane walk in interpret mode, its C++ compaction)."""
    B, L = 8, 260
    row, got = walk_probe.correctness(np.random.default_rng(0), B, L,
                                      device="cpu")
    assert row == {"phase": "correctness", "pairs": B, "mismatches": 0}
    ss, ts, s_lens, t_lens, dmin, w_eff = walk_probe.correctness_inputs(
        np.random.default_rng(0), B, L)
    kw = dict(W=128, subst=jax_walk.SUBST, go=-2.0, ge=-1.0, flags=LOCAL,
              w_eff=jnp.asarray(w_eff))
    res = banded_dp_pallas_ad(*[jnp.asarray(x) for x in
                                (ss, ts, s_lens, t_lens, dmin)],
                              with_dirs=True, block_b=8, interpret=True,
                              r_chunk=16, **kw)
    dminq = parity_adjusted_dmin(dmin, np.arange(B, dtype=np.int32) % 2)
    end_i = np.asarray(res.end_i).astype(np.int32)
    end_j = np.asarray(res.end_j).astype(np.int32)
    tr0, tr1, fi, fj = traceback_sweep(res.dirs, jnp.asarray(dminq),
                                       jnp.asarray(end_i),
                                       jnp.asarray(end_j), W=128,
                                       block_b=8, r_rows=8, interpret=True)
    want = ref_native.compact_sweep_ops(
        np.asarray(tr0), np.asarray(tr1), np.asarray(fi), np.asarray(fj),
        ss, ts, jax_walk.FLAGS)
    assert list(got[0]) == list(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert min(len(ops) for ops in got[0]) > 30


def test_walk_probe_run_returns_both_phases():
    out = walk_probe.run(B=8, L=260, tB=4, tL=400, runs=1, device="cpu")
    assert out["mismatches"] == 0 and out["device"] == "cpu"
    assert out["dirs_plane_mb"] > out["trace_d2h_mb"] > 0
    assert len(out["s_per_batch_device_runs"]) == 1


def test_pipeline_tx_probe_matches_jax_extend_segments():
    """At n 4, len 200: the workload is the JAX probe's draw for draw,
    both legs agree, and the transcripts equal the JAX package's
    extend_segments (Pallas route in interpret mode) on it."""
    out = pipeline_tx_probe.run(n=4, core_len=200, reps=1, device="cpu")
    assert out["walks_agree"] is True
    for leg, _ in pipeline_tx_probe.LEGS:
        assert len(out[leg + "_gcups_runs"]) == 1
    S, T, segments = pipeline_tx_probe.build_workload(
        4, 200, np.random.default_rng(99))
    jS, jT, jsegments = jax_ptx.build_workload(4, 200,
                                               np.random.default_rng(99))
    np.testing.assert_array_equal(S.to_array(), jS.to_array())
    np.testing.assert_array_equal(T.to_array(), jT.to_array())
    assert segments == jsegments
    got = pipeline_tx_probe.run_once(S, T, segments, True, "cpu")[2]
    want = ref_pipeline.extend_segments(
        jS, jT, jsegments, subst=pipeline_tx_probe.SUBST, go_score=-2.0,
        ge_score=-1.0, use_pallas=True, _interpret=True, _r_chunk=16,
        with_transcripts=True, pad_radius=16)
    key = lambda rows: [(r["transcript"], r["score"], r["origin_start"],
                         r["mutate_start"]) for r in rows]
    assert key(got) == key(want)
    assert min(r["score"] for r in got) > 100


def test_adkernel_probe_parity_and_jax_scores():
    """K1 and K4 agree exactly on the probe's batch (parity 0.0), and
    K1's scores equal the JAX kernel's (interpret mode)."""
    B, L, band = 4, 300, 100
    out = adkernel_probe.run(B=B, L=L, band=band, runs=1, device="cpu")
    assert out["parity"] == 0.0 and out["device"] == "cpu"
    args = adkernel_probe.inputs(0, B, L, band)
    w_eff = np.full((B,), band, np.int32)
    got = banded_dp_ad(*args, w_eff=w_eff, device="cpu",
                       **adkernel_probe.KW).score.numpy()
    kw = dict(adkernel_probe.KW, flags=LOCAL)
    want = banded_dp_pallas_ad(*[jnp.asarray(x) for x in args],
                               w_eff=jnp.asarray(w_eff), block_b=8,
                               r_chunk=16, interpret=True, **kw).score
    np.testing.assert_array_equal(got, np.asarray(want))
    assert out["scores_max"] == float(got.max()) > 5


def test_txpath_probe_returns_its_keys(monkeypatch):
    """The four legs' medians and runs (at 8 x 600 here), and
    ``--quick`` runs the JAX script's quick size."""
    out = txpath_probe.run(B=8, L=600, reps=2, device="cpu")
    for leg in ("h2d", "dp_dirs", "dp_walk", "dp_walk_synced"):
        assert out[leg + "_ms"] == float(np.median(out[leg + "_ms_runs"]))
        assert len(out[leg + "_ms_runs"]) == 2
    assert (out["B"], out["L"], out["device"]) == (8, 600, "cpu")
    seen = []
    monkeypatch.setattr(txpath_probe, "run", lambda **kw: seen.append(kw)
                        or {})
    monkeypatch.setattr(sys, "argv", ["txpath_probe", "--quick"])
    txpath_probe.main()
    assert seen == [dict(B=256, L=2048)]
