"""biseqt_tpu_torch: the PyTorch + CUDA port of :mod:`biseqt_tpu`.

The JAX package stays the reference; this package re-implements three
of its paths on PyTorch tensors, with every Pallas TPU kernel on them
rewritten as a hand-written CUDA C++ kernel for Hopper (``csrc/*.cu``):

* batched banded extension with transcripts
  (:func:`biseqt_tpu_torch.pipeline.extend_segments`): the antidiagonal
  DP kernel and the traceback walk;
* pairwise alignment (:class:`biseqt_tpu_torch.pw.Aligner`), whose
  backends are the row-wavefront reference engine (``"lax"``), the
  C++ host engine (``"native"``), the antidiagonal DP kernel
  (``"pallas"``) and the row DP kernel (``"pallas_row"``);
* the two experiment probes (:mod:`biseqt_tpu_torch.experiments`): a
  transpose of the direction plane and packed int16 ops.

Every entry point takes ``device``, ``"cuda"`` by default: there it
launches its kernels, and it raises where no card is present; on
``"cpu"`` it runs the kernels' plain PyTorch twins.

Module names follow the JAX package.  Importing this package imports
neither ``jax`` nor ``biseqt_tpu`` and builds nothing: kernels and the
C++ host tier (its own copy of ``pwnative.cpp``) compile on first use.
"""

__version__ = "0.2.0"
