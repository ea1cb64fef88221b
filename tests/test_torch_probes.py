"""The port's experiment probes against the JAX package's probes.

* The transpose probe (experiments/transpose_probe.py): the plain
  version of ``transpose_minor`` equals the probe's own check,
  ``transpose(0, 2, 1)`` (:84), and its two XLA legs,
  ``jnp.swapaxes(x, 1, 2)`` (:45) and the same through int32 (:55).
  The probe's Mosaic leg (:66-79) is not a reference: it swaps axes 0
  and 1 of its [1, BT, W] block and is refused (the last test here).
* The int16 probe (experiments/mosaic_i16_probe.py): the ten op bodies
  of its ``main()`` (:42-62), copied below because they are nested
  there, run through ``pl.pallas_call(..., interpret=True)`` with the
  harness of ``try_op`` (:20-31), against the port's plain versions.

Inputs come from a numpy seed, or are the probes' own.  Tolerance is 0:
every result is integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from biseqt_tpu_torch.experiments import i16_probe, transpose_probe
from biseqt_tpu_torch.experiments.i16_probe import (OPS, i16_op,
                                                    i16_op_reference)
from biseqt_tpu_torch.experiments.transpose_probe import (
    transpose_minor, transpose_minor_reference)

# the probe's block rows and lanes (transpose_probe.py:41, :64)
BT = W = 128
SHAPES = [(2, BT, W), (3, 2 * BT, W), (3, 40, 72), (1, 1, 1), (2, 130, 257),
          (1, 7, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_transpose_matches_probe_legs(rng, shape):
    x = rng.integers(0, 256, shape).astype(np.uint8)
    n0 = transpose_probe.LAUNCHES
    got = transpose_minor(x, device="cpu")
    assert transpose_probe.LAUNCHES == n0          # the CPU launches nothing
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert got.shape == (shape[0], shape[2], shape[1])
    np.testing.assert_array_equal(got.numpy(), x.transpose(0, 2, 1))
    xj = jnp.asarray(x)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.swapaxes(xj, 1, 2)))
    via_i32 = jnp.swapaxes(xj.astype(jnp.int32), 1, 2).astype(jnp.uint8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(via_i32))
    np.testing.assert_array_equal(
        transpose_minor_reference(torch.as_tensor(x), device="cpu").numpy(),
        got.numpy())


def test_transpose_of_a_view_and_bad_input(rng):
    """A non-contiguous view is transposed as its values; wrong types
    and ranks raise."""
    x = torch.as_tensor(rng.integers(0, 256, (4, 64, 96)).astype(np.uint8))
    view = x[1:3, ::2, 5:]
    np.testing.assert_array_equal(transpose_minor(view, device="cpu").numpy(),
                                  view.numpy().transpose(0, 2, 1))
    with pytest.raises(ValueError, match="uint8"):
        transpose_minor(x.to(torch.int32), device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        transpose_minor(x[0], device="cpu")


def test_probe_mosaic_leg_is_refused():
    """The reference probe's kernel as written (transpose_probe.py:66-79)
    swaps the wrong axes and is refused, so the port computes what the
    probe's check states instead."""
    def tr_kernel(x_ref, o_ref):
        v = x_ref[:].astype(jnp.int32)
        o_ref[:] = jnp.swapaxes(v, 0, 1).astype(jnp.uint8)

    x = jnp.zeros((2, BT, W), jnp.uint8)
    with pytest.raises(Exception, match="swap|shape"):
        pl.pallas_call(
            tr_kernel, grid=(x.shape[0],),
            in_specs=[pl.BlockSpec((1, BT, W), lambda r: (r, 0, 0))],
            out_specs=pl.BlockSpec((1, W, BT), lambda r: (r, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((x.shape[0], W, BT), jnp.uint8),
            interpret=True,
        )(x)


def _iota():
    return jax.lax.broadcasted_iota(jnp.int32, (256, 128), 1)


# mosaic_i16_probe.py:42-62, verbatim
REF_BODIES = {
    "add": lambda x: x + jnp.int16(3),
    "max": lambda x: jnp.maximum(x, jnp.int16(7)),
    "min-vec (mask trick)": lambda x: jnp.minimum(x, jnp.where(
        _iota() < 100, jnp.int16(32000), jnp.int16(-20000))),
    "roll": lambda x: pltpu.roll(x, 1, 1),
    "roll127": lambda x: pltpu.roll(x, 127, 1),
    "where(i1,i16,i16)": lambda x: jnp.where(_iota() < 100, x,
                                             jnp.int16(-20000)),
    "select from i32 cmp": lambda x: jnp.where(
        x.astype(jnp.int32) % 2 == 0, x, jnp.int16(-1)),
    "i32->i16 cast": lambda x: (x.astype(jnp.int32) + 5).astype(jnp.int16),
    "i16 cmp + i16 sel": lambda x: jnp.where(x == jnp.int16(4), x,
                                             jnp.int16(-2)),
    "slice value [r:r+W]": lambda x: jnp.pad(
        x, ((0, 0), (0, 128)))[:, 3:131].astype(jnp.int16),
}


def try_op(body, x):
    """try_op's harness (mosaic_i16_probe.py:20-31) in interpret mode."""
    def kernel(x_ref, o_ref):
        o_ref[:] = body(x_ref[:])

    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((256, 128), jnp.int16),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x)))


def test_ops_are_the_probes():
    assert OPS == tuple(REF_BODIES)


@pytest.mark.parametrize("name", OPS)
def test_i16_op_matches_probe_kernel(rng, name):
    """The probe's input (arange, which reaches 32767 so the add and the
    cast wrap) and random int16 over the whole range, including 4s."""
    random = rng.integers(-32768, 32768, (256, 128)).astype(np.int16)
    random[::3, ::5] = 4
    n0 = i16_probe.LAUNCHES
    for x in (i16_probe.probe_input(), random):
        want = try_op(REF_BODIES[name], x)
        got = i16_op(name, x, device="cpu")
        assert got.dtype == torch.int16 and got.shape == (256, 128)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            i16_op_reference(name, torch.as_tensor(x), device="cpu").numpy(),
            want)
    assert i16_probe.LAUNCHES == n0                # the CPU launches nothing


def test_i16_op_ragged_rows_and_bad_input(rng):
    """Any row count: each row is the op of that row alone."""
    x = rng.integers(-32768, 32768, (13, 128)).astype(np.int16)
    for name in OPS:
        got = i16_op(name, x, device="cpu").numpy()
        for r in (0, 12):
            np.testing.assert_array_equal(
                got[r], i16_op(name, x[r:r + 1], device="cpu").numpy()[0])
    assert i16_op("roll", x, device="cpu")[0, :2].tolist() == \
        [x[0, 127], x[0, 0]]
    with pytest.raises(ValueError, match="unknown op"):
        i16_op("mul", x, device="cpu")
    with pytest.raises(ValueError, match="int16"):
        i16_op("add", x.astype(np.int32), device="cpu")
    with pytest.raises(ValueError, match="int16"):
        i16_op("add", x[:, :64], device="cpu")
