"""biseqt_tpu_torch: the PyTorch + CUDA port of :mod:`biseqt_tpu`.

The JAX package stays the reference; this package re-implements its
batched banded-extension-with-transcripts path
(:func:`biseqt_tpu_torch.pipeline.extend_segments`) on PyTorch tensors,
with the two Pallas TPU kernels of that path rewritten as hand-written
CUDA C++ kernels for Hopper (``csrc/*.cu``).  Every kernel wrapper takes
an explicit ``device``: on ``"cuda"`` it launches its kernel, on
``"cpu"`` it runs the kernel's plain PyTorch twin.

Module names follow the JAX package.  Importing this package imports
neither ``jax`` nor ``biseqt_tpu`` and builds nothing: kernels and the
shared C++ host tier compile on first use.
"""

__version__ = "0.1.0"
