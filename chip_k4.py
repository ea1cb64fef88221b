"""Times the row DP kernel K4 (csrc/dp_row.cu) on one card.

    python3 chip_k4.py                # everything below
    python3 chip_k4.py --lone         # the lone 100 kbp pair (B_LOCAL) only
    python3 chip_k4.py --sass PATH    # also write the kernel's SASS to PATH

K4 by CUDA events (mean of 3 after a warm-up) at two shapes:

* the score bench of ``chip_smoke.py`` phase 7 (``SCORE_BENCH``: 4096
  random pairs of 10 kbp, band 100, W 128, local, go -2, ge -1; the same
  seed): score-only on all 4096 pairs and with directions on 512, with
  the bound of ``profiling.bound_ms`` and its share;
* the 100 kbp DNA pair of phase 6 (the same seed, drawn after the same
  planted blocks), through ``Aligner._row_args`` in each banded mode (W
  512): score-only and with directions, microseconds a row, and the
  walls of ``Aligner.solve()`` and ``traceback()`` (host clock, second
  of two calls).

Where the checkout's ``ops/dp_row`` has a planner (``plan``), it also
times the kernel's other geometries: the lone pair with each block
instance's lanes a thread (4 and 8: 4 and 2 warps), the score bench as
a warp per pair and as a block per pair, batches of 1-4096 pairs at W
128 and 256 in both geometries, and of 1-1056 pairs at W 512 in each
block geometry; and each instance's registers, spills and SASS
instructions a row (with the loop that holds each spill).  It uses only
what every checkout of the port has, so one call can time a parent commit
and its change: copy this file into each checkout and run it there.
Prints the card's name and power limit last; exits 1 without a card.
"""

import subprocess
import sys
import time

SWEEP_B = (1, 8, 66, 132, 264, 528, 1056, 4096)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_k4: FAILED: this run needs a card", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    from biseqt_tpu_torch import pw
    from biseqt_tpu_torch.ops import dp_row
    from biseqt_tpu_torch.ops.banded_dp import ModeFlags
    from biseqt_tpu_torch.profiling import FP32_OPS_PER_S, bound_ms, cuda_ms
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    argv = sys.argv[1:]
    lone_only = "--lone" in argv
    sass_path = argv[argv.index("--sass") + 1] if "--sass" in argv else None
    dev = torch.device("cuda", 0)
    planner = None
    if hasattr(dp_row, "plan"):
        sms = dp_row.sm_count(dev)
        planner = lambda B, W, d=False: dp_row.plan(B, W, d, sms=sms)
    if not lone_only:
        sass_report(dp_row, sass_path)
    A4 = Alphabet("ACGT")
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)

    def k4_ms(on, kw, geometry=None):
        if geometry is not None:
            kw = dict(kw, _geometry=geometry)
        return cuda_ms(lambda: dp_row.banded_dp_row(*on, **kw), 3)

    # -- the 100 kbp pair, as phase 6 draws it ---------------------------
    rng = np.random.default_rng(20261016)
    cs.plant(np, rng, A4, Sequence)
    core = rng.integers(0, 4, cs.PAIR_LEN).astype(np.int8)
    mut = cs.mutate(np, rng, core, 4, 0.10, 40, 1000)
    S, T = Sequence(A4, core), Sequence(A4, mut)
    rows = len(S)
    types = (pw.B_LOCAL,) if lone_only else pw.BANDED_TYPES
    for alntype in types:
        kw = dict(alnmode=pw.BANDED_MODE, alntype=alntype,
                  diag_range=cs.PAIR_BAND, go_score=cs.GO, ge_score=cs.GE,
                  backend="pallas_row", device=dev)
        with pw.Aligner(S, T, **kw) as aln:
            args, rkw = aln._row_args(with_dirs=True)
        on = [torch.as_tensor(np.asarray(a), device=dev) for a in args]
        solve_kw = dict(rkw, with_dirs=False)
        solve_ms, dirs_ms = k4_ms(on, solve_kw), k4_ms(on, rkw)
        print("k4 100 kbp pair %s (W %d%s): score-only %.3f ms (%.4f us a"
              " row), with directions %.3f ms (%.4f us a row)"
              % (alntype, rkw["W"], plan_text(planner, 1, rkw["W"]),
                 solve_ms, solve_ms * 1e3 / rows, dirs_ms,
                 dirs_ms * 1e3 / rows))
        if planner is not None and alntype == pw.B_LOCAL:
            for lpt in dp_row.BLOCK_LPT:
                g = dp_row.Geometry(lpt, False)
                g_ms = k4_ms(on, solve_kw, g)
                print("k4 100 kbp pair %s, %d warps of %d lanes a thread:"
                      " score-only %.3f ms (%.4f us a row), with directions"
                      " %.3f ms" % (alntype, g.threads(rkw["W"]) // 32, lpt,
                                    g_ms,
                                    g_ms * 1e3 / rows, k4_ms(on, rkw, g)))
        if lone_only:
            continue
        walls = []
        for _ in range(2):
            with pw.Aligner(S, T, **kw) as aln:
                t0 = time.perf_counter()
                aln.solve()
                t1 = time.perf_counter()
                aln.traceback()
                t2 = time.perf_counter()
            walls.append((t1 - t0, t2 - t1))
        print("Aligner %s on the 100 kbp pair: solve %.4f s, traceback %.4f"
              " s (second call; first %.4f, %.4f)"
              % (alntype, walls[1][0], walls[1][1], walls[0][0],
                 walls[0][1]))
    if lone_only:
        print(card_line())
        return

    # -- the score bench, as phase 7 draws it ----------------------------
    sb = cs.SCORE_BENCH
    rr = np.random.default_rng(20261017)
    B = sb["B"]
    host = (rr.integers(0, 4, (B, sb["L"]), dtype=np.int8),
            rr.integers(0, 4, (B, sb["L"]), dtype=np.int8),
            np.full((B,), sb["n"], np.int32), np.full((B,), sb["n"], np.int32),
            np.full((B,), -(sb["band"] // 2), np.int32))
    on = [torch.from_numpy(v).to(dev) for v in host]
    rkw = dict(W=sb["W"], subst=subst, go=-2.0, ge=-1.0,
               flags=ModeFlags(local_start=True, local_end=True),
               w_eff=torch.full((B,), sb["band"], dtype=torch.int32,
                                device=dev), device=dev)
    nd = 512
    dkw = dict(rkw, w_eff=rkw["w_eff"][:nd], with_dirs=True)
    on_d = [v[:nd] for v in on]
    band_cells = B * sb["n"] * sb["band"]
    res = dp_row.banded_dp_row(*on, **rkw)
    bound, bound_by = bound_ms(
        cs.nbytes(*on, rkw["w_eff"], subst, *res),
        cs.DP_ROW_OPS_PER_CELL * band_cells, FP32_OPS_PER_S)
    ms, d_ms = k4_ms(on, rkw), k4_ms(on_d, dkw)
    print("k4 score bench (%d x %d, W %d%s): score-only %.3f ms (%.1f"
          " GCUPS; bound %.4f ms, %s, share %.2f%%); with directions on %d"
          " pairs %.3f ms" % (B, sb["n"], sb["W"],
                              plan_text(planner, B, sb["W"]), ms,
                              band_cells / ms / 1e6, bound, bound_by,
                              100 * bound / ms, nd, d_ms))
    if planner is not None:
        geos = [dp_row.Geometry(4, True)]
        geos += [dp_row.Geometry(lpt, False) for lpt in dp_row.BLOCK_LPT]
        for g in geos:
            print("k4 score bench in %s: score-only %.3f ms, with directions"
                  " %.3f ms" % (g, k4_ms(on, rkw, g), k4_ms(on_d, dkw, g)))
        # batches of SWEEP_B pairs at W 128 and 256, both geometries, and
        # of 1-1056 pairs at W 512 in each block geometry (with directions
        # up to 264 pairs: the plane of 1056 is 5.5 GB)
        for W in (128, 256, 512):
            wkw = dict(rkw, W=W, w_eff=torch.full((B,), W, dtype=torch.int32,
                                                  device=dev))
            won = on[:4] + [torch.full((B,), -(W // 2), dtype=torch.int32,
                                       device=dev)]
            if W == 512:
                cases = [(n, d) for n in (1, 66, 264, 1056)
                         for d in (False, True) if not (d and n > 264)]
            else:
                cases = [(n, False) for n in SWEEP_B]
            geos = [dp_row.Geometry(lpt, False) for lpt in dp_row.BLOCK_LPT]
            if W < 512:
                geos.append(dp_row.Geometry(W // 32, True))
            for n, d in cases:
                sub = [v[:n] for v in won]
                nkw = dict(wkw, w_eff=wkw["w_eff"][:n], with_dirs=d)
                p = planner(n, W, d)
                line = ["k4 W %d, %d pairs%s: plan %s %.3f ms" % (
                    W, n, ", with directions" if d else "", p,
                    k4_ms(sub, nkw, p))]
                for g in geos:
                    if g != p:
                        line.append("%s %.3f" % (g, k4_ms(sub, nkw, g)))
                print("; ".join(line))
    print(card_line())


def sass_report(dp_row, path=None):
    """Registers and spills of each instance (``-Xptxas -v``) and the
    SASS instructions of its row loop (``cuobjdump -sass``), written
    whole to ``path`` where one is given."""
    from biseqt_tpu_torch import _build
    from biseqt_tpu_torch.profiling import cuobjdump_sass, sass_step_loop

    t0 = time.perf_counter()
    _build.load("dp_row", dp_row._declare)
    print("k4 build: %.1f s" % (time.perf_counter() - t0))
    function = ""
    for line in _build.build_log("dp_row").splitlines():
        if "Function properties for" in line:
            function = line.split("Function properties for")[1].strip()
        elif "registers" in line or "spill" in line:
            print("ptxas %s: %s" % (function, line.strip()))
    try:
        sass = cuobjdump_sass(_build.so_path("dp_row"))
    except (OSError, subprocess.SubprocessError) as e:
        print("k4 SASS: not measured (cuobjdump failed: %s)" % e)
        return
    if path:
        with open(path, "w") as f:
            f.write(sass)
    for name in sorted(set(n for n in sass.split()
                           if "dp_row_kernel" in n)):
        try:
            loop = sass_step_loop(sass, name, barrier=False)
        except TypeError:          # a parser that wants a barrier
            loop = sass_step_loop(sass, name)
        if loop is not None:
            print("k4 SASS row loop of %s: %d instructions, %d barriers;"
                  " spills by the instructions of the loop that holds each"
                  " (0: none) %s" % (name, loop["instructions"],
                                     loop["barriers"],
                                     loop.get("spills", "not counted")))


def plan_text(planner, B, W):
    """The planner's geometries for a call, where the checkout has one."""
    if planner is None:
        return ""
    return "; solve %s, with directions %s" % (planner(B, W),
                                               planner(B, W, True))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


if __name__ == "__main__":
    main()
