"""The antidiagonal DP kernel against the row kernel: the port of
``experiments/adkernel_probe.py`` (its ``main``).

4096 pairs of 10 kbp (in 10240-letter rows) at band 100, W 128, local
mode, unit matrix: K1 (:func:`..ops.dp_ad.banded_dp_ad`) and K4
(:func:`..ops.dp_row.banded_dp_row`) score the same inputs, and their
scores must agree exactly (``parity``, the largest difference, 0.0).
Then K1's cells a second, serialised (each run's scores copied to the
host before the next launch) and pipelined (every run launched, then
every score copied), with fresh inputs each run copied to the card
before the clock starts.  The JAX script's ``strip_probe`` times
variants of its TPU kernel and has no counterpart.

    python -m biseqt_tpu_torch.experiments.adkernel_probe
"""

import argparse
import json
import time

import numpy as np
import torch

from ..ops.banded_dp import ModeFlags, on_device, resolve_device
from ..ops.dp_ad import banded_dp_ad
from ..ops.dp_row import banded_dp_row
from ..profiling import materialize

__all__ = ["inputs", "run", "main", "KW"]

SUBST = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
KW = dict(W=128, subst=SUBST, go=-2.0, ge=-1.0,
          flags=ModeFlags(local_start=True, local_end=True))


def inputs(seed, B=4096, L=10240, band=100):
    """The JAX probe's batch of ``seed`` (numpy): codes [B, L], lengths
    ``L - 240``, ``dmin = -band // 2``."""
    rr = np.random.default_rng(seed * 1_000_003 + 11)
    lens = np.full((B,), L - 240, np.int32)
    return (rr.integers(0, 4, (B, L), dtype=np.int8),
            rr.integers(0, 4, (B, L), dtype=np.int8), lens, lens.copy(),
            np.full((B,), -(band // 2), np.int32))


def run(B=4096, L=10240, band=100, runs=4, device="cuda"):
    """Parity of K1 and K4 on seed 0, then K1 serialised and pipelined
    over ``runs`` fresh batches each; one dict."""
    device = resolve_device(device)
    w_eff = torch.full((B,), band, dtype=torch.int32, device=device)
    types = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)

    def on_card(seed):
        return materialize([on_device(x, t, device)
                            for x, t in zip(inputs(seed, B, L, band), types)])

    def k1(args):
        return banded_dp_ad(*args, w_eff=w_eff, device=device, **KW).score

    a0 = on_card(0)
    ad = k1(a0)
    row = banded_dp_row(*a0, w_eff=w_eff, device=device, **KW).score
    parity = float((ad - row).abs().max())
    cells = B * (L - 240) * band

    def timed(pipelined, first_seed):
        batches = [on_card(first_seed + k) for k in range(runs)]
        t0 = time.perf_counter()
        if pipelined:
            [o.cpu() for o in [k1(a) for a in batches]]
        else:
            for a in batches:
                k1(a).cpu()
        return (time.perf_counter() - t0) / runs

    serial = timed(False, 1)
    pipe = timed(True, 101)
    return {"metric": "adkernel_probe", "B": B, "L": L, "band": band,
            "parity": parity, "scores_max": float(ad.max()),
            "serialized_ms": serial * 1e3,
            "serialized_gcups": cells / serial / 1e9,
            "pipelined_ms": pipe * 1e3,
            "pipelined_gcups": cells / pipe / 1e9,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def main():
    argparse.ArgumentParser(description=__doc__).parse_args()
    out = run()
    print(json.dumps(out))
    if out["parity"] != 0.0:
        raise SystemExit("K1 and K4 scores differ by %r" % out["parity"])


if __name__ == "__main__":
    main()
