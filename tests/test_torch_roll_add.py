"""superbblas_tpu_torch.ops.roll_add (E2) on the CPU: its plain version
against the probe's own kernel ``k_roll_f32``
(experiments/stencil_bf16_roll_probe.py) run through ``pl.pallas_call`` in
interpret mode, and against the probe's numpy ``want``; the wrapper's
refusals.  The kernel's own tests are in test_torch_cuda.py."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import collect_garbage  # noqa: F401  (fixture)
from superbblas_tpu_torch.ops import roll_add as R

pytestmark = pytest.mark.usefixtures("collect_garbage")

PROBE = os.path.join(os.path.dirname(__file__), "..", "experiments",
                     "stencil_bf16_roll_probe.py")


def probe():
    spec = importlib.util.spec_from_file_location("stencil_bf16_roll_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_input(shape, seed=0):
    """The same bf16 values as a JAX array and a torch tensor."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(8, 4, 128), (3, 8, 10)])
def test_plain_version_matches_probe_kernel_interpret(shape):
    """Bit for bit against k_roll_f32 (convert, roll, add, round once)."""
    jx, tx = bf16_input(shape)
    fn = pl.pallas_call(probe().k_roll_f32, out_shape=jax.ShapeDtypeStruct(shape,
                                                                           jnp.bfloat16),
                        interpret=True)
    want = np.asarray(fn(jx).astype(jnp.float32))
    got = R.roll_add(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape", [(256, 32, 256), (5, 7)])
def test_plain_version_matches_probe_want(shape):
    """At the probe's shape (and a ragged 2-D one) against the probe's
    numpy ``want`` (roll and add in f32): within half a bf16 ulp, the
    rounding of the result."""
    _, tx = bf16_input(shape, seed=1)
    xf = tx.float().numpy()
    want = np.roll(xf, 1, -1) + xf
    got = R.roll_add_reference(tx).float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want))


def test_variants_and_refusals():
    """On the CPU both variants are the plain version; a variant name, a
    dtype or an empty tensor the kernel does not take raises on every
    device."""
    _, tx = bf16_input((4, 6), seed=2)
    before = R.roll_add.launches
    for v in R.VARIANTS:
        assert torch.equal(R.roll_add(tx, v), R.roll_add_reference(tx))
    assert R.roll_add.launches == before
    with pytest.raises(ValueError, match="variant"):
        R.roll_add(tx, "f16")
    with pytest.raises(ValueError, match="bf16"):
        R.roll_add(tx.float())
    with pytest.raises(ValueError, match="bf16"):
        R.roll_add(tx[:0])
    with pytest.raises(ValueError, match="no kernel for device"):
        R.roll_add(torch.empty((4, 6), dtype=torch.bfloat16, device="meta"))


@pytest.mark.parametrize("T,x_off,y_off,variant,form", [
    (256, 0, 0, "f32", "vec16"), (8, 0, 0, "bf16x2", "vec16"), (264, 0, 0, "f32", "vec16"),
    (256, 4, 0, "f32", "pair"), (256, 0, 2, "f32", "elem"), (6, 0, 0, "bf16x2", "pair"),
    (7, 0, 0, "f32", "elem"), (262, 16, 16, "bf16x2", "pair")])
def test_roll_add_form_from_shape_and_alignment(T, x_off, y_off, variant, form):
    """The kernel's form from the last axis and the two pointers' byte
    offsets alone: vec16 where T % 8 == 0 and both are 16-byte aligned,
    pair where T is even and both 4-byte aligned, elem else."""
    assert R.roll_add_form(T, 256 + x_off, 512 + y_off, variant) == form


def test_roll_add_form_refuses_bf16x2_without_pairs():
    """The bf16x2 variant adds aligned pairs: an odd T or a pointer off 4
    bytes has no form for it."""
    with pytest.raises(ValueError, match="even"):
        R.roll_add_form(7, 0, 0, "bf16x2")
    with pytest.raises(ValueError, match="even"):
        R.roll_add_form(256, 2, 0, "bf16x2")
    assert R.FORMS == ("vec16", "pair", "elem")
