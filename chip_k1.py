"""Times the DP kernel K1 (csrc/dp_ad.cu) on the launches of
chip_smoke.py's main path, on one card.

    python3 chip_k1.py

Plants chip_smoke.py's 2048 homologous 10 kbp blocks (same seed), plans
the launches of ``extend_segments`` as the checkout's pipeline plans
them (plus the 12-segment narrow launch), and times K1 with directions
on each launch's inputs by CUDA events (mean of 3 after a warm-up): the
sum is K1's time per smoke call.  It also times K1 on all 2048
segments in one launch, on the first 490 segments alone (512 pairs, 256
plane rows: the full launch of the TPU's per-launch budget), on those
inputs tiled or sliced to 44-2048 plane rows, and ``extend_segments``
end to end (host clock, three calls).  It
uses only what every checkout of the port has, so one call can time a
parent commit and its change: copy this file into each checkout and run
it there.  Exits 1 without a card.
"""

import subprocess
import sys
import time

ROWS_IN_FLIGHT = (44, 128, 256, 512, 528, 1024, 1056, 2048)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_k1: FAILED: this run needs a card", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    from biseqt_tpu_torch import pipeline
    from biseqt_tpu_torch.ops import dp_ad
    from biseqt_tpu_torch.ops.banded_dp import ModeFlags
    from biseqt_tpu_torch.profiling import cuda_ms
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    S, T, segments = cs.plant(np, rng, Alphabet("ACGT"), Sequence)
    s_arr, t_arr = S.to_array(), T.to_array()
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    flags = ModeFlags(local_start=True, local_end=True)
    cut = [pipeline.cut_segment(seg, len(S), len(T)) for seg in segments]
    launches = (pipeline.plan_launches(cut, True)
                + pipeline.plan_launches(cut[:cs.NARROW], True))

    def on_card(idxs, LS, LT, W):
        x = pipeline.launch_inputs(cut, idxs, LS, LT, W, s_arr, t_arr, True)
        return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}

    def k1_ms(on, W):
        return cuda_ms(lambda: dp_ad.banded_dp_ad(
            on["s_codes"], on["t_codes"], on["s_lens"], on["t_lens"],
            on["dmin"], W=W, subst=subst, go=cs.GO, ge=cs.GE, flags=flags,
            w_eff=on["w_eff"], with_dirs=True, device=dev), 3)

    total = 0.0
    for idxs, LS, LT, W in launches:
        on = on_card(idxs, LS, LT, W)
        ms = k1_ms(on, W)
        total += ms
        print("k1 launch: %d pairs (%d real), LS %d, LT %d, W %d: %.3f ms"
              % (len(on["dmin"]), len(idxs), LS, LT, W, ms))
        del on
    print("k1 per smoke call: %d launches, %.3f ms" % (len(launches), total))
    idxs, LS, LT, W = launches[0]
    whole = on_card(list(range(len(cut))), LS, LT, W)
    print("k1 on all %d segments in one launch: %.3f ms"
          % (len(cut), k1_ms(whole, W)))
    del whole
    full = on_card(idxs[:490], LS, LT, W)
    print("k1 on the first 490 segments (%d pairs): %.3f ms"
          % (len(full["dmin"]), k1_ms(full, W)))
    for n_rows in ROWS_IN_FLIGHT:
        pairs = 2 * n_rows
        tiled = {k: v.repeat((-(-pairs // len(v)),))[:pairs]
                 for k, v in full.items() if v.dim() == 1}
        tiled.update({k: v.repeat((-(-pairs // len(v)), 1))[:pairs]
                      for k, v in full.items() if v.dim() == 2})
        ms = k1_ms(tiled, W)
        print("k1 rows in flight: %d plane rows, %.3f ms, %.5f ms per row"
              % (n_rows, ms, ms / n_rows))
        del tiled
    del full
    kw = dict(subst=subst, go_score=cs.GO, ge_score=cs.GE,
              with_transcripts=True, device=dev)
    walls = []
    for k in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.extend_segments(S, T, segments, **kw)
        torch.cuda.synchronize()
        if k:                        # the first call warms up
            walls.append(time.perf_counter() - t0)
    print("extend_segments end to end: %s s"
          % ", ".join("%.3f" % w for w in walls))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip())


if __name__ == "__main__":
    main()
