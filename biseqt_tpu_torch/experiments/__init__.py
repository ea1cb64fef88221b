"""The port's counterparts of the JAX package's ``experiments/`` scripts.

The two probes that launch a kernel of their own, each with a
hand-written CUDA kernel for Hopper, its plain PyTorch version and a
``main()`` that runs the probe on the card:

* :mod:`.transpose_probe` (``experiments/transpose_probe.py``): what a
  transposed direction plane costs;
* :mod:`.i16_probe` (``experiments/mosaic_i16_probe.py``): ten int16 ops
  done the way a 16-bit DP would do them, two per 32-bit register.

The four probes that time the port's own path on the card (the JAX
scripts' functions, arguments and JSON keys, less the TPU's knobs; each
a ``run(..., device="cuda")`` that returns its JSON dict and a
``main()`` that prints it):

* :mod:`.pipeline_tx_probe` (``experiments/pipeline_tx_probe.py``):
  ``extend_segments`` with transcripts, the device walk against the
  host walk;
* :mod:`.walk_probe` (``experiments/walk_probe.py``): the walk kernel
  against the host walker, then DP and walk throughput;
* :mod:`.adkernel_probe` (``experiments/adkernel_probe.py``): K1 against
  K4 (score parity), then K1 serialised and pipelined;
* :mod:`.txpath_probe` (``experiments/txpath_probe.py``): the copy to
  the card, the DP, and the DP and walk with and without a host wait.

The user-facing experiments, one module per JAX script with its
functions' names, arguments, defaults, printed lines and dump-row keys
(so :mod:`.figures` renders either package's dumps), each computing on
``device`` (the card unless a caller asks for the CPU):

* :mod:`.band_radius_stats`: the band-radius model's containment (host);
* :mod:`.wordblot_recall`: Word-Blot recall@k over a p_min sweep;
* :mod:`.multiple_homology`: N-way homology on 10 x ~100 kbp;
* :mod:`.fixed_ref_bench`: reads mapped to a 5 Mbp reference;
* :mod:`.ingest_bench`: a 5 Mbp FASTA into the DB (host);
* :mod:`.index_build_bench`: the k-mer table and all-vs-all statistics
  of 1000 x 10 kbp reads;
* :mod:`.genome_homology`: discovery and extension on a rearranged
  genome pair, with transcripts through the DP and walk kernels;
* :mod:`.overlap_recall`: all-vs-all overlap precision and recall;
* :mod:`.protein_search`: two-tier protein search on the DP kernel;
* :mod:`.figures` and :mod:`.util`: the plots and the helpers.

    python -m biseqt_tpu_torch.experiments.transpose_probe
    python -m biseqt_tpu_torch.experiments.walk_probe
    python -m biseqt_tpu_torch.experiments.genome_homology --transcripts
    python -m biseqt_tpu_torch.experiments.wordblot_recall --quick
"""
