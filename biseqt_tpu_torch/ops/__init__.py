"""Device-side ops: the banded-DP contract and the hand-written kernels
(antidiagonal DP, traceback walk) with their plain PyTorch twins."""
