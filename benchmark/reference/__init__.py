"""The benchmark's plain reference: NumPy and PyTorch only, nothing of
the program under test (a test holds every import of this package)."""
