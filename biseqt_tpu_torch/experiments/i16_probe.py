"""Packed 16-bit integer ops: CUDA kernel + plain versions, and the probe.

The port of ``experiments/mosaic_i16_probe.py``, which tries ten int16
vector ops one by one in a TPU kernel (``kernel``, launched by
``try_op``) to learn which the TPU's compiler lowers, as the building
blocks of a 16-bit DP.  On Hopper the question is what the packed
16-bit path gives, so the kernel of ``csrc/i16_probe.cu`` does each op
the way a 16-bit DP would: two int16 per 32-bit register with the
SIMD-in-word intrinsics, 16-byte accesses (16 threads a 128-lane row),
lane rolls and shifted slices as width-16 warp shuffles plus
``__byte_perm``, two chunks in flight a thread, one instance per op, and
as many blocks as the array needs.

:func:`i16_op` applies one op, by the probe's name (:data:`OPS`), to an
int16 ``[R, 128]`` array, with the probe's semantics: int16 wrap-around
on the add and on the int32 -> int16 cast, and ``roll`` as ``jnp.roll``
along the lanes (``out[j] = x[(j - shift) mod 128]``).  On a CUDA tensor
it launches the kernel; on a CPU tensor it runs
:func:`i16_op_reference`, the op in plain PyTorch, which is also the
library call the kernel is timed against.

    python -m biseqt_tpu_torch.experiments.i16_probe

prints ``OK name`` or ``FAIL name: reason`` per op, as the TPU probe
does; on the card "OK" means equal to the plain version on the probe's
input (:func:`run`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.banded_dp import resolve_device
from ..profiling import INT32_OPS_PER_S, bound_ms, cuda_ms

__all__ = ["i16_op", "i16_op_reference", "i16_bound_ms", "probe_input",
           "run", "main", "OPS", "LANES", "LAUNCHES"]

# CUDA kernel launches made by i16_op (never by the plain versions)
LAUNCHES = 0

LANES = 128
REPS = 20                 # timed runs of each op


def _lane(x):
    return torch.arange(LANES, device=x.device)


# the probe's ten ops (mosaic_i16_probe.py:42-62), in its order, as the
# plain PyTorch versions; the index of a name is the kernel's op code
_PLAIN = {
    "add": lambda x: x + 3,
    "max": lambda x: torch.clamp(x, min=7),
    "min-vec (mask trick)": lambda x: torch.minimum(
        x, torch.where(_lane(x) < 100, 32000, -20000).to(torch.int16)),
    "roll": lambda x: torch.roll(x, 1, 1),
    "roll127": lambda x: torch.roll(x, 127, 1),
    "where(i1,i16,i16)": lambda x: torch.where(_lane(x) < 100, x, -20000),
    "select from i32 cmp": lambda x: torch.where(
        x.to(torch.int32) % 2 == 0, x, -1),
    "i32->i16 cast": lambda x: (x.to(torch.int32) + 5).to(torch.int16),
    "i16 cmp + i16 sel": lambda x: torch.where(x == 4, x, -2),
    "slice value [r:r+W]": lambda x: F.pad(x, (0, LANES))[:, 3:3 + LANES]
    .contiguous(),
}
OPS = tuple(_PLAIN)


def probe_input() -> np.ndarray:
    """The probe's input: ``arange`` over int16 ``[256, 128]``."""
    return np.arange(256 * LANES, dtype=np.int16).reshape(256, LANES)


def _rows(x, device: torch.device) -> torch.Tensor:
    """``x`` as a contiguous int16 [R, 128] tensor on ``device``: a numpy
    array is copied there, a tensor must already live there."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError("tensor on %s passed with device=%s"
                             % (x.device, device))
    else:
        x = torch.as_tensor(np.asarray(x), device=device)
    if x.dtype != torch.int16 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError("x must be int16 [R, %d], got %s %s"
                         % (LANES, x.dtype, tuple(x.shape)))
    return x.contiguous()


def _op_code(name: str) -> int:
    if name not in _PLAIN:
        raise ValueError("unknown op %r; the probe's ops are %s"
                         % (name, ", ".join(OPS)))
    return OPS.index(name)


def _i16_cuda(op: int, x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    from .. import _build

    if x.data_ptr() % 16:
        x = x.clone()             # the kernel moves 16-byte chunks
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    lib = _build.load("i16_probe", _declare)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = lib.bst_i16_op(
        ptr(x), ptr(out), x.shape[0], op, x.device.index,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, rc, "i16 op launch")
    LAUNCHES += 1
    return out


def _declare(lib):
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.bst_i16_op.restype = i
    lib.bst_i16_op.argtypes = [v, v, i, i, i, v]


def i16_op(name: str, x, *, device="cuda") -> torch.Tensor:
    """Op ``name`` (one of :data:`OPS`) of the int16 [R, 128] array
    ``x``: a new int16 [R, 128] tensor.

    On a CUDA ``device`` this launches the kernel of
    ``csrc/i16_probe.cu`` and raises if it cannot; on the CPU it runs
    :func:`i16_op_reference`.
    """
    device = resolve_device(device)
    op = _op_code(name)
    x = _rows(x, device)
    if device.type == "cuda":
        return _i16_cuda(op, x)
    return _PLAIN[name](x)


def i16_op_reference(name: str, x, *, device="cuda") -> torch.Tensor:
    """The plain PyTorch version of :func:`i16_op` on any device: same
    arguments, same values."""
    device = resolve_device(device)
    _op_code(name)
    return _PLAIN[name](_rows(x, device))


def i16_bound_ms(x: torch.Tensor) -> float:
    """The least time the card could take for one op over ``x``: each
    int16 read once and written once; at most two packed instructions
    per pair of lanes, far under the bytes' time."""
    return bound_ms(2 * x.numel() * x.element_size(), x.numel(),
                    INT32_OPS_PER_S)[0]


def run(rows=(256,)):
    """Every op on the card, at each row count in ``rows`` (256 is the
    probe's input; other counts take random int16), held to its plain
    version exactly.  Returns one dict per op and row count:
    ``{"op", "rows", "ok", "error", "max_abs_err", "ms", "plain_ms",
    "bound_ms"}``, times with the L2 cache flushed before each run."""
    dev = resolve_device("cuda")
    rng = np.random.default_rng(0)
    out = []
    for R in rows:
        host = (probe_input() if R == 256 else
                rng.integers(-32768, 32768, (R, LANES)).astype(np.int16))
        x = torch.as_tensor(host, device=dev)
        for name in OPS:
            row = {"op": name, "rows": R, "ok": False, "error": None}
            try:
                got = i16_op(name, x, device=dev)
                want = i16_op_reference(name, x, device=dev)
                row["ok"] = got.dtype == want.dtype and torch.equal(got, want)
                if not row["ok"]:
                    row["error"] = "differs from the plain version on %d" \
                        " of %d values" % (int((got != want).sum()),
                                           want.numel())
                row["max_abs_err"] = float(
                    (got.int() - want.int()).abs().max())
                row["ms"] = cuda_ms(lambda: i16_op(name, x, device=dev),
                                    REPS, cold=True)
                row["plain_ms"] = cuda_ms(
                    lambda: i16_op_reference(name, x, device=dev), REPS,
                    cold=True)
                row["bound_ms"] = i16_bound_ms(x)
            except RuntimeError as e:
                row["error"] = str(e).split("\n")[0][:140]
            out.append(row)
    return out


def main():
    rows = run()
    print("card: %s" % torch.cuda.get_device_name(0))
    for row in rows:
        if row["ok"]:
            print("OK   %s (%.4f ms, plain %.4f ms)"
                  % (row["op"], row["ms"], row["plain_ms"]), flush=True)
        else:
            print("FAIL %s: %s" % (row["op"], row["error"]), flush=True)


if __name__ == "__main__":
    main()
