"""The banded-DP contract shared by every engine of the port.

The port's counterpart of :mod:`biseqt_tpu.ops.banded_dp` holds, for
now, only the contract: ``NEG``, :class:`ModeFlags`, :class:`DPResult`,
and the device rules every kernel wrapper shares (:func:`resolve_device`,
:func:`on_device`).  The JAX package's row-wavefront ``lax`` engine
(``banded_dp``, ``full_dp``, tracebacks) is ported by a later slice; the
engine of this slice is the antidiagonal kernel in :mod:`.dp_ad`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = -1e30  # finite -inf; float32(NEG) is what the kernels carry

__all__ = ["ModeFlags", "DPResult", "NEG", "resolve_device", "on_device"]


class ModeFlags(NamedTuple):
    """Static alignment-mode switches (the alntype family as predicates)."""
    free_start_edges: bool = False  # start anywhere on row 0 / column 0
    local_start: bool = False       # start anywhere (Smith-Waterman origin)
    free_end_edges: bool = False    # end anywhere on last row / last column
    local_end: bool = False         # end anywhere (max over all cells)


class DPResult(NamedTuple):
    score: torch.Tensor     # [B] best score per pair under the mode
    end_i: torch.Tensor     # [B] row of the optimum (i index, 0..LS)
    end_j: torch.Tensor     # [B] col of the optimum (j index, 0..LT)
    dirs: torch.Tensor      # direction bytes, or an empty tensor


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, with the index of the
    current CUDA device filled in for a bare ``"cuda"``.  Only the CPU
    and CUDA are supported."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % device)
    return device


def on_device(x, dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``.  A numpy array (or list)
    is copied there; a tensor must already live there, because a kernel
    wrapper never moves a caller's data between the card and the host."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError("tensor on %s passed with device=%s"
                             % (x.device, device))
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)
