"""The port's counterparts of the JAX package's ``experiments/`` scripts.

So far the two probes that launch a TPU kernel of their own, each with a
hand-written CUDA kernel for Hopper, its plain PyTorch version and a
``main()`` that runs the probe on the card:

* :mod:`.transpose_probe` (``experiments/transpose_probe.py``): what a
  transposed direction plane costs;
* :mod:`.i16_probe` (``experiments/mosaic_i16_probe.py``): ten int16 ops
  done the way a 16-bit DP would do them, two per 32-bit register.

    python -m biseqt_tpu_torch.experiments.transpose_probe
    python -m biseqt_tpu_torch.experiments.i16_probe
"""
