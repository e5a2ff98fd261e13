"""superbblas_tpu_torch.models.coarse against superbblas_tpu.models.coarse
on the same numpy inputs: the operator bit for bit, its apply, and CG on
it with the JAX package's iteration count (tests/test_solvers.py:18-32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, collect_garbage,  # noqa: F401  (fixture)
                           crand_np, to_np)
from superbblas_tpu import cplx as JC
from superbblas_tpu import solvers as JS
from superbblas_tpu.models import coarse as JCo
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch import solvers as TS
from superbblas_tpu_torch.models import coarse as TCo

pytestmark = pytest.mark.usefixtures("collect_garbage")

PRECISIONS = {np.float64: (jnp.complex128, torch.complex128),
              np.float32: (jnp.complex64, torch.complex64)}


def ops(lat, nc, mass, key, dtype):
    jd, td = PRECISIONS[dtype]
    return (JCo.coarse_operator(lat, block_size=nc, mass=mass, key=key, dtype=jd),
            TCo.coarse_operator(lat, block_size=nc, mass=mass, key=key, dtype=td,
                                device="cpu"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_operator_equals_jax_exactly(dtype):
    jop, top = ops((4, 2, 2, 3), 8, 0.5, 3, dtype)
    assert top.mode == jop.mode == "stencil" and top.offsets == jop.offsets
    assert (top.bi, top.bd, top.lat_d, top.blk_d) == (jop.bi, jop.bd, jop.lat_d, jop.blk_d)
    for j, t in ((jop.blocks.re, top.blocks_re), (jop.blocks.im, top.blocks_im)):
        assert t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("complex_input", [False, True])
def test_apply_coarse_matches_jax(dtype, complex_input):
    """f64 at 1e-10; f32 at the parity helper's 1e-5 (sums of 9 * 8
    products)."""
    lat, nc = (4, 2, 2, 3), 8
    jop, top = ops(lat, nc, 0.5, 3, dtype)
    jx, tx = both(crand_np(lat + (nc, 4), 5, dtype))
    if complex_input:
        jx, tx = JC.to_complex(jx), TC.to_complex(tx)
    got, want = TCo.apply_coarse(top, tx), JCo.apply_coarse(jop, jx)
    if complex_input:
        assert got.is_complex()
        got, want = TC.from_complex(got), JC.from_complex(want)
    assert_parity(got, want, dtype, rtol=1e-10 if dtype == np.float64 else None)


def test_cg_on_coarse_operator_matches_jax():
    """Coarse operator + shift is Hermitian PD; CG to 1e-10 takes the JAX
    package's iteration count, and the answers agree to 1e-10."""
    lat, nc = (4, 4), 6
    jop, top = ops(lat, nc, 8.0, 2, np.float64)
    rng = np.random.default_rng(0)
    parts = (rng.standard_normal(lat + (nc, 1)), rng.standard_normal(lat + (nc, 1)))
    jb, tb = both(parts)
    jx, _, jk = JS.cg(lambda v: JCo.apply_coarse(jop, v), jb, tol=1e-10, maxiter=500)
    tx, _, tk = TS.cg(lambda v: TCo.apply_coarse(top, v), tb, tol=1e-10, maxiter=500)
    assert tk == int(jk)
    assert_parity(tx, jx, np.float64, rtol=1e-10)
    res = TCo.apply_coarse(top, tx)
    rel = np.sqrt(((to_np(res.re) - parts[0]) ** 2 + (to_np(res.im) - parts[1]) ** 2).sum()
                  / (parts[0] ** 2 + parts[1] ** 2).sum())
    assert rel < 1e-8, (rel, tk)


def test_coarse_operator_defaults_to_the_card():
    """Without ``device`` the operator is built on the card; where there is
    none the call raises rather than building on the CPU."""
    if torch.cuda.is_available():
        assert TCo.coarse_operator((2, 2, 2, 2), 4).blocks_re.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            TCo.coarse_operator((2, 2, 2, 2), 4)
