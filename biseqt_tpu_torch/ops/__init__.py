"""Device-side ops: the banded-DP contract and reference engine, and the
hand-written kernels (antidiagonal DP, traceback walk, row DP) with
their plain PyTorch twins."""
