"""Transposed direction plane: CUDA kernel + plain version, and the probe.

The port of ``experiments/transpose_probe.py``, which measures what a
direction plane with its two minor axes swapped costs (a walk that
packs walkers along the fast axis would read one).  Its TPU kernel,
``tr_kernel`` (launched by ``run_tr``), swaps axes 0 and 1 of its
``[1, BT, W]`` block, which yields ``[BT, 1, W]`` and is refused
("Invalid shape for swap"); the probe's own check,
``transpose(0, 2, 1)``, states the function meant, and this module
computes that: ``out[r, w, b] = plane[r, b, w]``.

:func:`transpose_minor` launches the kernel of
``csrc/transpose_probe.cu`` on a CUDA tensor and runs
:func:`transpose_minor_reference` on a CPU one.  The plain version is
PyTorch's own transpose copy, so it is also the library call the kernel
is timed against.

    python -m biseqt_tpu_torch.experiments.transpose_probe

runs the probe's legs on the card (:func:`run`): PyTorch's transpose of
the u8 plane, the same through int32, and the kernel on the probe's
``[256, 128, 128]`` sub-plane and on the whole plane, each checked
against the plain version, with milliseconds and effective GB/s.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.banded_dp import resolve_device
from ..profiling import bound_ms, cuda_ms

__all__ = ["transpose_minor", "transpose_minor_reference",
           "transpose_bound_ms", "run", "main", "LAUNCHES", "PLANE", "SUB"]

# CUDA kernel launches made by transpose_minor (never by the plain version)
LAUNCHES = 0

PLANE = (1288, 512, 128)   # the probe's plane: [Rp, B2, W] u8, 84.4 MB
SUB = (256, 128, 128)      # the plane rows and columns its kernel ran on
REPS = 20                  # timed runs of each leg


def _plane(plane, device: torch.device) -> torch.Tensor:
    """``plane`` as a contiguous uint8 [R, B, W] tensor on ``device``: a
    numpy array is copied there, a tensor must already live there."""
    if isinstance(plane, torch.Tensor):
        if plane.device != device:
            raise ValueError("tensor on %s passed with device=%s"
                             % (plane.device, device))
    else:
        plane = torch.as_tensor(np.asarray(plane), device=device)
    if plane.dtype != torch.uint8 or plane.dim() != 3:
        raise ValueError("plane must be uint8 [R, B, W], got %s %s"
                         % (plane.dtype, tuple(plane.shape)))
    return plane.contiguous()


def _transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def _transpose_cuda(x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    from .. import _build

    R, B, W = x.shape
    out = torch.empty((R, W, B), dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("transpose_probe", _declare)
    # 4-byte accesses need 4-byte rows and aligned bases
    vec = (B % 4 == 0 and W % 4 == 0 and x.data_ptr() % 4 == 0
           and out.data_ptr() % 4 == 0)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = lib.bst_transpose_minor(
        ptr(x), ptr(out), R, B, W, int(vec), x.device.index,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, rc, "transpose launch")
    LAUNCHES += 1
    return out


def _declare(lib):
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.bst_transpose_minor.restype = i
    lib.bst_transpose_minor.argtypes = [v, v, i, i, i, i, i, v]


def transpose_minor(plane, *, device="cuda") -> torch.Tensor:
    """``plane`` [R, B, W] uint8 with its two minor axes swapped: a new
    contiguous [R, W, B] tensor.

    On a CUDA ``device`` this launches the kernel of
    ``csrc/transpose_probe.cu`` and raises if it cannot; on the CPU it
    runs :func:`transpose_minor_reference`.
    """
    device = resolve_device(device)
    x = _plane(plane, device)
    if device.type == "cuda":
        return _transpose_cuda(x)
    return _transpose_plain(x)


def transpose_minor_reference(plane, *, device="cuda") -> torch.Tensor:
    """The plain PyTorch version of :func:`transpose_minor` on any
    device (``plane.transpose(1, 2).contiguous()``): same arguments,
    same bytes."""
    return _transpose_plain(_plane(plane, resolve_device(device)))


def transpose_bound_ms(plane: torch.Tensor) -> float:
    """The least time the card could take to transpose ``plane``: every
    byte read once and written once, no arithmetic."""
    return bound_ms(2 * plane.numel(), 0, 1.0)[0]


def run():
    """The probe's legs on the card, each a dict ``{"leg", "shape",
    "ok", "ms", "gbps", "bound_ms"}`` (``ok``: equal to the plain
    version; ``ms``: with the L2 cache flushed before each run;
    ``gbps``: bytes read plus bytes written over the time)."""
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    plane = torch.randint(0, 256, PLANE, dtype=torch.uint8, device=dev,
                          generator=gen)
    sub = plane[:SUB[0], :SUB[1], :SUB[2]].contiguous()
    want, want_sub = _transpose_plain(plane), _transpose_plain(sub)

    def via_i32():
        return plane.to(torch.int32).transpose(1, 2).contiguous().to(
            torch.uint8)

    legs = [
        ("library_transpose_u8", plane, want,
         lambda: transpose_minor_reference(plane, device=dev)),
        ("library_transpose_via_i32", plane, want, via_i32),
        ("kernel_transpose_u8", sub, want_sub,
         lambda: transpose_minor(sub, device=dev)),
        ("kernel_transpose_u8", plane, want,
         lambda: transpose_minor(plane, device=dev)),
    ]
    rows = []
    for leg, x, ref, fn in legs:
        ok = torch.equal(fn(), ref)
        ms = cuda_ms(fn, REPS, cold=True)
        rows.append({"leg": leg, "shape": list(x.shape), "ok": ok, "ms": ms,
                     "gbps": 2 * x.numel() / ms / 1e6,
                     "bound_ms": transpose_bound_ms(x)})
    return rows


def main():
    rows = run()
    print("card: %s" % torch.cuda.get_device_name(0))
    for row in rows:
        print("%s %s: ok=%s %.4f ms for %.1f MB (%.1f GB/s eff; bound"
              " %.4f ms)" % (row["leg"], row["shape"], row["ok"], row["ms"],
                             np.prod(row["shape"]) / 1e6, row["gbps"],
                             row["bound_ms"]))


if __name__ == "__main__":
    main()
