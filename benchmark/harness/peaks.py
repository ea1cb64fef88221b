"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
H100 data sheet and Hopper white paper), the roofline's ceilings.

HBM3: 3.35 TB/s.  Float32 outside the tensor cores: 67 TFLOP/s with a
fused multiply-add counted as two operations, i.e. 33.5 T float
instructions a second (132 SMs x 128 float32 lanes x 1.98 GHz); an add,
a max or a compare is one instruction.  32-bit integer instructions:
half that (64 lanes per SM).  The same numbers as the library's
``profiling`` module, copied so that the yardstick cannot move with it.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
INT32_OPS_PER_S = 16.75e12


def bound_s(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """The least seconds the card could take for work that moves
    ``nbytes`` to or from device memory and does ``ops`` operations:
    the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
