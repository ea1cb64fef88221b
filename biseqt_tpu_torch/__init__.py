"""biseqt_tpu_torch: the PyTorch + CUDA port of :mod:`biseqt_tpu`.

The JAX package stays the reference; this package re-implements two of
its paths on PyTorch tensors, with every Pallas TPU kernel on them
rewritten as a hand-written CUDA C++ kernel for Hopper (``csrc/*.cu``):

* batched banded extension with transcripts
  (:func:`biseqt_tpu_torch.pipeline.extend_segments`): the antidiagonal
  DP kernel and the traceback walk;
* pairwise alignment (:class:`biseqt_tpu_torch.pw.Aligner`), whose
  backends are the row-wavefront reference engine (``"lax"``), the
  shared C++ host engine (``"native"``), the antidiagonal DP kernel
  (``"pallas"``) and the row DP kernel (``"pallas_row"``).

Every kernel wrapper takes an explicit ``device``: on ``"cuda"`` it
launches its kernel, on ``"cpu"`` it runs the kernel's plain PyTorch
twin.

Module names follow the JAX package.  Importing this package imports
neither ``jax`` nor ``biseqt_tpu`` and builds nothing: kernels and the
shared C++ host tier compile on first use.
"""

__version__ = "0.2.0"
