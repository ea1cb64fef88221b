"""biseqt_tpu_torch: the PyTorch + CUDA port of :mod:`biseqt_tpu`.

The JAX package stays the reference; this package re-implements its
paths on PyTorch tensors, with every Pallas TPU kernel on them
rewritten as a hand-written CUDA C++ kernel for Hopper (``csrc/*.cu``):

* Word-Blot discovery with extension in one call
  (:func:`biseqt_tpu_torch.pipeline.discover_and_extend`) and batched
  banded extension with transcripts (:func:`~biseqt_tpu_torch.pipeline.
  extend_segments`): the antidiagonal DP kernel and the traceback walk;
* pairwise alignment (:class:`biseqt_tpu_torch.pw.Aligner`), whose
  backends are the row-wavefront reference engine (``"lax"``), the
  C++ host engine (``"native"``), the antidiagonal DP kernel
  (``"pallas"``) and the row DP kernel (``"pallas_row"``);
* ingest, the k-mer index, the fixed-reference and N-way Word-Blot
  modes (:mod:`~biseqt_tpu_torch.database`, :mod:`~biseqt_tpu_torch.
  kmers`, :mod:`~biseqt_tpu_torch.blot`);
* all-vs-all read overlaps (:func:`biseqt_tpu_torch.parallel.
  all_vs_all_overlaps`, the sort-join engine :mod:`~biseqt_tpu_torch.
  ops.allvsall_sorted`, the (data, band) mesh over a
  ``torch.distributed`` group) and the batch tier of
  :mod:`~biseqt_tpu_torch.stochastics` that makes their workloads, and
  their resumable block-checkpointed sweep (:func:`biseqt_tpu_torch.
  parallel.checkpointed_overlap_sweep`);
* giant single pairs with the band split over the mesh's band axis
  (:func:`biseqt_tpu_torch.parallel.banded_dp_band_sharded`, the row
  engine; :func:`~biseqt_tpu_torch.parallel.banded_dp_band_sharded_ad`,
  the antidiagonal engine, and :func:`~biseqt_tpu_torch.parallel.
  band_sharded_ad_traceback`, its transcripts from checkpointed window
  re-solves): plain PyTorch, edge lanes traded point to point;
* two-tier protein search (:func:`biseqt_tpu_torch.protein.
  two_tier_scores`) on the antidiagonal DP kernel;
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
