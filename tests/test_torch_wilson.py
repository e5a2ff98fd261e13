"""superbblas_tpu_torch.models.wilson and .bsr against
superbblas_tpu.models.wilson on the same numpy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, crand_np, to_np,
                           torch_one_thread, collect_garbage)  # noqa: F401  (fixtures)
from superbblas_tpu.bsr import bsr_cast_storage as jax_cast_storage
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import bsr as TB
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch.models import wilson as TW

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

LAT = (2, 4, 8, 128)
PRECISIONS = {np.float64: (jnp.complex128, torch.complex128),
              np.float32: (jnp.complex64, torch.complex64)}


def ops(dtype, storage=None):
    jd, td = PRECISIONS[dtype]
    jop = JW.wilson_operator(LAT, mass=0.1, key=0, layout="soa", dtype=jd,
                             storage_dtype=None if storage is None else jnp.bfloat16)
    top = TW.wilson_operator(LAT, mass=0.1, key=0, dtype=td, device="cpu",
                             storage_dtype=None if storage is None else torch.bfloat16)
    return jop, top


def field(dtype, seed=1, n=2):
    return both(crand_np((n, 12) + LAT, seed, dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_operator_equals_jax_exactly(dtype):
    jop, top = ops(dtype)
    for j, t in ((jop.blocks.re, top.blocks_re), (jop.blocks.im, top.blocks_im),
                 (jop.kron.re, top.kron_re), (jop.kron.im, top.kron_im)):
        assert t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert top.offsets == jop.offsets and top.ndir == jop.ndir == 9
    assert (top.bi, top.bd, top.ki, top.kd) == (jop.bi, jop.bd, jop.ki, jop.kd)
    assert (top.dim_i, top.oim, top.odm) == (jop.dim_i, jop.oim, jop.odm)


@pytest.mark.parametrize("storage", [None, "bf16"])
def test_operator_from_numpy_carries_jax_operator(storage):
    jop2 = JW.wilson_operator(LAT, mass=0.3, key=5, layout="soa", dtype=jnp.complex64)
    a = lambda v: np.asarray(v)  # noqa: E731
    port = TB.operator_from_numpy(
        a(jop2.blocks.re), a(jop2.blocks.im), a(jop2.kron.re), a(jop2.kron.im),
        jop2.offsets, jop2.dim_i, jop2.bi, jop2.bd, jop2.ki, jop2.kd, device="cpu",
        storage_dtype=None if storage is None else torch.bfloat16)
    jx, tx = field(np.float32)
    if storage is not None:
        # bf16-stored blocks are converted on load: hold against JAX with
        # the same bf16-rounded blocks in f32
        jop2 = dataclasses.replace(jop2, blocks=type(jop2.blocks)(
            jnp.asarray(to_np(port.blocks_re), jnp.float32),
            jnp.asarray(to_np(port.blocks_im), jnp.float32)))
        assert port.blocks_re.dtype == torch.bfloat16 and port.kron_re.dtype == torch.float32
    assert_parity(TW.apply_wilson(port, tx), JW.apply_wilson(jop2, jx), np.float32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("which", ["apply", "dagger", "forward"])
def test_apply_matches_jax(dtype, which):
    jop, top = ops(dtype)
    jx, tx = field(dtype)
    if which == "dagger":
        got, want = TW.apply_wilson_dagger(top, tx), JW.apply_wilson_dagger(jop, jx)
    else:
        got = top(tx) if which == "forward" else TW.apply_wilson(top, tx)
        want = JW.apply_wilson(jop, jx)
    assert_parity(got, want, dtype)


def test_bf16_storage_apply_matches_jax():
    """bf16-stored links, f32 fields: the port converts the stored links on
    load, so it matches JAX applying the same bf16-rounded links in f32."""
    jop, top = ops(np.float32, storage="bf16")
    assert top.blocks_re.dtype == torch.bfloat16 and top.kron_re.dtype == torch.float32
    np.testing.assert_array_equal(to_np(top.blocks_re), to_np(jop.blocks.re))
    jx, tx = field(np.float32)
    jop32 = jax_cast_storage(jop, jnp.float32)
    got = TW.apply_wilson(top, tx)
    assert got.re.dtype == torch.float32
    assert_parity(got, JW.apply_wilson(jop32, jx), np.float32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_adjoint_identity(dtype):
    """<y, D x> = <D^H y, x> for the complex inner product."""
    _, top = ops(dtype)
    _, tx = field(dtype, seed=2)
    _, ty = field(dtype, seed=3)
    dx = TW.apply_wilson(top, tx)
    dhy = TW.apply_wilson_dagger(top, ty)

    def inner(a, b):
        a, b = a.to(torch.float64), b.to(torch.float64)
        return complex(TC.inner_real(a, b), float((a.re * b.im - a.im * b.re).sum()))

    lhs, rhs = inner(ty, dx), inner(dhy, tx)
    scale = float(TC.inner_real(ty, ty) * TC.inner_real(dx, dx)) ** 0.5
    assert abs(lhs - rhs) <= (1e-12 if dtype == np.float64 else 1e-5) * scale


def test_adjoint_of_adjoint_is_operator():
    _, top = ops(np.float64)
    back = TW.adjoint_operator(TW.adjoint_operator(top))
    assert back.offsets == top.offsets
    for p, q in ((back.blocks_re, top.blocks_re), (back.blocks_im, top.blocks_im),
                 (back.kron_re, top.kron_re), (back.kron_im, top.kron_im)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("ncols", [1, 8])
@pytest.mark.parametrize("storage", [None, "bf16"])
def test_flop_and_byte_models_equal_jax(ncols, storage):
    jop, top = ops(np.float32, storage)
    assert top.flops_per_matvec(ncols) == jop.flops_per_matvec(ncols)
    assert top.flops_per_matvec(ncols, False) == jop.flops_per_matvec(ncols, False)
    for itemsize in (4, 8):
        assert top.memops_per_matvec(ncols, itemsize) == jop.memops_per_matvec(ncols, itemsize)
    # per site and column, f32 Wilson: 6048 flops
    assert top.flops_per_matvec(1) == 6048 * int(np.prod(LAT))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cg_solve_matches_jax(dtype):
    """10 CG iterations on the normal equations, 2 right-hand sides.  CG
    amplifies differences in summation order: rtol 1e-9 at f64, 1e-4 at
    f32.  At f32 the |r|^2 is held against JAX's f64 solve: JAX's CPU f32
    sums carry ~1e-5 relative error each (torch's pairwise sums ~1e-8),
    which leaves JAX's own f32 |r|^2 1.1e-4 from its f64 value here."""
    jop, top = ops(dtype)
    jb, tb = field(dtype, seed=4)
    jx, jrs = JW.cg_solve(jop, jb, n_iters=10)
    tx, trs = TW.cg_solve(top, tb, n_iters=10)
    rtol = 1e-9 if dtype == np.float64 else 1e-4
    assert_parity(tx, jx, dtype, rtol=rtol)
    if dtype == np.float32:
        jop64, _ = ops(np.float64)
        b64 = tuple(p.astype(np.float64) for p in crand_np((2, 12) + LAT, 4, dtype))
        jrs = JW.cg_solve(jop64, both(b64)[0], n_iters=10)[1]
    assert trs.ndim == 0 and trs.dtype == tx.re.dtype
    np.testing.assert_allclose(float(trs), float(jrs), rtol=rtol)


def _build_without_device(entry):
    lat = (2, 2, 2, 4)
    if entry == "wilson_operator":
        return TW.wilson_operator(lat, key=0)
    blocks = np.zeros(lat + (9, 3, 3), np.float32)
    if entry == "bsr_from_stencil":
        return TB.bsr_from_stencil("xyztc", "xyztC", lat, {"c": 3}, {"C": 3},
                                   TW.wilson_offsets(4), TC.CArray(blocks, blocks))
    soa = np.zeros((9, 9) + lat, np.float32)
    return TB.operator_from_numpy(soa, soa, None, None, TW.wilson_offsets(4), lat, 3, 3)


@pytest.mark.parametrize("entry", ["wilson_operator", "bsr_from_stencil",
                                   "operator_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` an operator is built on the card; where there is
    none the call raises rather than building on the CPU."""
    if torch.cuda.is_available():
        assert _build_without_device(entry).blocks_re.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            _build_without_device(entry)
