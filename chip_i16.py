"""Times the int16 probe kernel P2 (csrc/i16_probe.cu) on one card.

    python3 chip_i16.py                          # 256, 65536, 1048576 rows
    python3 chip_i16.py --rows 65536 --passes 5

Calls the checkout's own ``i16_probe.run(rows)`` ``--passes`` times (3
by default) in one process and prints, for each pass and row count, the
ten ops' kernel and plain times summed, their share of the bound and
each op's kernel / plain ms, then one JSON line of every reading and the
card's name and power limit.  The timing is ``run``'s, so the script
also runs unchanged in an older checkout of the port: copy it into that
checkout to compare two commits in one call.  Exits 1 without a card or
when an op differs from its plain version.
"""

import json
import subprocess
import sys


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_i16: FAILED: this run needs a card", file=sys.stderr)
        sys.exit(1)
    from biseqt_tpu_torch.experiments import i16_probe

    argv = sys.argv[1:]
    arg = lambda flag, default: (
        [int(v) for v in argv[argv.index(flag) + 1].split(",")]
        if flag in argv else default)
    rows = arg("--rows", [256, 65536, 1 << 20])
    passes = arg("--passes", [3])[0]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], check=True, capture_output=True, text=True,
        timeout=60).stdout.strip())
    out = []
    for p in range(passes):
        got = i16_probe.run(rows)
        bad = [r for r in got if not r["ok"]]
        if bad:
            print("chip_i16: FAILED: %s" % bad[0], file=sys.stderr)
            sys.exit(1)
        for R in rows:
            ten = [r for r in got if r["rows"] == R]
            ms = sum(r["ms"] for r in ten)
            bound = sum(r["bound_ms"] for r in ten)
            print("pass %d, %7d rows: ten ops %.4f ms (plain %.4f), bound"
                  " %.4f ms, share %.1f%%; kernel / plain per op %s"
                  % (p, R, ms, sum(r["plain_ms"] for r in ten), bound,
                     100 * bound / ms, " ".join(
                         "%.4f/%.4f" % (r["ms"], r["plain_ms"])
                         for r in ten)), flush=True)
        out += [dict(r, **{"pass": p}) for r in got]
    print(json.dumps({"i16": out}))


if __name__ == "__main__":
    main()
