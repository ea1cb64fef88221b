"""FASTA ingest benchmark: a 5 Mbp genome into the DB, the port of
``experiments/ingest_bench.py``.

Writes a random genome as FASTA, ingests it with ``DB.load_fasta`` (the
C++ packer, SHA-1 content id, the pool's ``.npy`` file and one SQLite
row) and loads it back; ``--python-too`` also times the per-letter
Python reader on an open file.  Host work only, no device.

Usage: python -m biseqt_tpu_torch.experiments.ingest_bench
[--size 5000000] [--python-too]
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..database import DB
from ..sequence import Alphabet


def run(size=5_000_000, python_too=False):
    """The experiment's JSON row for a genome of ``size`` letters."""
    A4 = Alphabet("ACGT")
    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"ACGT", np.uint8)
    out = {"size": size}

    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "genome.fa")
        codes = rng.integers(0, 4, size)
        txt = letters[codes].tobytes().decode()
        with open(fa, "w") as f:
            f.write(">chr1 synthetic\n")
            for off in range(0, len(txt), 80):
                f.write(txt[off:off + 80] + "\n")

        db_path = os.path.join(td, "db.sqlite")
        t0 = time.perf_counter()
        db = DB(db_path, A4)
        recs = db.load_fasta(fa)
        out["native_ingest_s"] = round(time.perf_counter() - t0, 4)
        if len(recs) != 1:
            raise RuntimeError("ingest gave %d records, not 1" % len(recs))
        t0 = time.perf_counter()
        seq = db.load_from_record(recs[0])
        out["load_record_s"] = round(time.perf_counter() - t0, 4)
        if len(seq) != size:
            raise RuntimeError("the record holds %d letters, not %d"
                               % (len(seq), size))
        db.close()

        if python_too:
            db2 = DB(os.path.join(td, "db2.sqlite"), A4)
            t0 = time.perf_counter()
            with open(fa) as f:
                recs2 = db2.load_fasta(f, source_file=fa)
            out["python_ingest_s"] = round(time.perf_counter() - t0, 4)
            if recs2[0].content_id != recs[0].content_id:
                raise RuntimeError("the Python reader's content id differs"
                                   " from the packer's")
            db2.close()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=5_000_000)
    ap.add_argument("--python-too", action="store_true",
                    help="also time the pure-Python reader tier")
    args = ap.parse_args()
    print(json.dumps(run(args.size, args.python_too)))


if __name__ == "__main__":
    main()
