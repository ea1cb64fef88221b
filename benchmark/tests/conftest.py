"""The benchmark's own tests (CPU; the cases marked ``cuda`` decide
inside the test whether a card is present).  Run from the repository's
root: ``python -m pytest -q benchmark/tests``."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]
