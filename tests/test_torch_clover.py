"""superbblas_tpu_torch.models.clover against superbblas_tpu.models.clover on
the same numpy links, in both layouts; the port's torch field strength and
clover blocks against the JAX package's numpy ones; the clover term's SoA
stencil (K1 at (1, 1, 12, 12)) against the TPU kernel in interpret mode;
and the port's versions of the JAX package's clover oracles
(tests/test_models.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, collect_garbage, crand_np,  # noqa: F401
                           gamma5_np, materialize, to_np, torch_one_thread)
from superbblas_tpu.bsr import apply_stencil_soa as japply_soa
from superbblas_tpu.models import clover as JC
from superbblas_tpu.models import wilson as JW
from superbblas_tpu.ops import stencil_pallas as JS
from superbblas_tpu_torch.bsr import apply_stencil_soa
from superbblas_tpu_torch.models import clover as TC
from superbblas_tpu_torch.models import wilson as TW
from superbblas_tpu_torch.ops.stencil import soa_to_aos

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

#: the JAX package builds SoA operators only where T % 128 == 0, Z % 8 == 0
LATS = {"aos": (2, 2, 2, 4), "soa": (2, 2, 8, 128)}
DTYPES = {np.float64: (jnp.complex128, torch.complex128),
          np.float32: (jnp.complex64, torch.complex64)}
#: f32 results against JAX: 3e-4 of max |y| (the two sum in other orders)
RTOL = {np.float64: None, np.float32: 3e-4}


def test_field_strength_matches_jax():
    """The torch field strength (any device) against the JAX package's
    numpy one, every (mu, nu)."""
    links = JW.random_su3_links(np.random.default_rng(1), (2, 3, 2, 4))
    for mu in range(4):
        for nu in range(mu + 1, 4):
            got = TC.clover_field_strength(torch.from_numpy(links), mu, nu)
            want = JC.clover_field_strength(links, mu, nu)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_matches_jax(layout, dtype):
    """Blocks of both terms and the apply agree; the SoA clover term is
    one centre direction of 12x12 blocks, no spin factor."""
    lat = LATS[layout]
    links = JW.random_su3_links(np.random.default_rng(2), lat)
    jdt, tdt = DTYPES[dtype]
    jop = JC.wilson_clover_operator(lat, mass=0.3, c_sw=1.2, links=links, dtype=jdt,
                                    layout=layout)
    top = TC.wilson_clover_operator(lat, mass=0.3, c_sw=1.2, links=links, dtype=tdt,
                                    layout=layout, device="cpu")
    assert top.clover.kron is None and top.clover.ndir == 1
    assert (top.clover.bi, top.clover.bd) == ((4, 3), (4, 3))
    # f32 blocks: the port and JAX round the complex128 sums of other orders
    assert_parity(top.clover.blocks, jop.clover.blocks, np.float64,
                  None if dtype == np.float64 else 1e-6)
    assert_parity(top.hop.blocks, jop.hop.blocks, np.float64)
    shape = (2, 12) + lat if layout == "soa" else lat + (4, 3, 2)
    jx, tx = both(crand_np(shape, 1, dtype))
    assert_parity(TC.apply_clover(top, tx), JC.apply_clover(jop, jx), dtype, RTOL[dtype])
    assert top.flops_per_matvec(2) == jop.flops_per_matvec(2)


def test_soa_clover_term_matches_jax_pallas_kernel():
    """The clover term's SoA stencil, K1's (1, 1, 12, 12) case, through
    the port's plain version against the TPU kernel itself (Pallas
    interpret mode), f32."""
    lat = (2, 2, 8, 128)
    links = JW.random_su3_links(np.random.default_rng(3), lat)
    jop = JC.wilson_clover_operator(lat, mass=0.3, c_sw=1.2, links=links, layout="soa")
    top = TC.wilson_clover_operator(lat, mass=0.3, c_sw=1.2, links=links, layout="soa",
                                    device="cpu")
    jx, tx = both(crand_np((1, 12) + lat, 4, np.float32))
    got = apply_stencil_soa(top.clover, tx)
    want = japply_soa(jop.clover, jx, interpret=True)
    assert_parity(got, want, np.float32, 3e-4)


@pytest.mark.parametrize("lat,n", [((3, 3, 3, 5), 1), ((3, 3, 3, 5), 9)])
def test_soa_clover_term_matches_jax_pallas_kernel_at_kernel_cases(lat, n):
    """The clover term's SoA stencil through the port against the TPU
    kernel (Pallas interpret mode) at the cases the card's block-streaming
    kernel splits on: an odd volume (135 sites, element copies) and 1 or 9
    columns (9: two column passes of 8, the second with one column), f32.
    The JAX package builds SoA operators only where T % 128 == 0 and
    Z % 8 == 0, so both take the port's clover blocks."""
    links = JW.random_su3_links(np.random.default_rng(3), lat)
    top = TC.wilson_clover_operator(lat, mass=0.3, c_sw=1.2, links=links, layout="soa",
                                    dtype=torch.complex64, device="cpu")
    blocks = tuple(to_np(p).astype(np.float32) for p in top.clover.blocks)
    jb, _ = both(blocks)
    jx, tx = both(crand_np((n, 12) + lat, 4, np.float32))
    got = apply_stencil_soa(top.clover, tx)
    want = JS.stencil_matvec_soa(jb, None, jx, top.clover.offsets, 12, 12, interpret=True)
    assert_parity(got, want, np.float32, 3e-4)


def test_blocks_hermitian():
    op = TC.wilson_clover_operator((2, 2, 2, 2), mass=0.1, c_sw=1.3, key=2,
                                   dtype=torch.complex128, layout="aos", device="cpu")
    blk = (to_np(op.clover.blocks.re) + 1j * to_np(op.clover.blocks.im)).reshape(-1, 12, 12)
    np.testing.assert_allclose(blk, np.swapaxes(blk, -1, -2).conj(), atol=1e-12)


def test_gamma5_hermiticity():
    """gamma5 D gamma5 = D^H for Wilson-clover."""
    lat = (2, 2, 2, 2)
    op = TC.wilson_clover_operator(lat, mass=0.15, c_sw=0.9, key=4, dtype=torch.complex128,
                                   layout="aos", device="cpu")
    D = materialize(lambda x: TC.apply_clover(op, x), lat, (4, 3))
    G5 = np.kron(np.eye(D.shape[0] // 12), np.kron(gamma5_np(), np.eye(3)))
    np.testing.assert_allclose(G5 @ D @ G5, D.conj().T, atol=1e-10)


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_reduces_to_wilson(layout):
    lat = (2, 2, 2, 2)
    rng = np.random.default_rng(0)
    links = TW.random_su3_links(rng, lat)
    kw = dict(mass=0.1, links=links, dtype=torch.complex128, layout=layout, device="cpu")
    opc = TC.wilson_clover_operator(lat, c_sw=0.0, **kw)
    opw = TW.wilson_operator(lat, **kw)
    shape = (2, 12) + lat if layout == "soa" else lat + (4, 3, 2)
    _, x = both(crand_np(shape, 5))
    yc, yw = TC.apply_clover(opc, x), TW.apply_wilson(opw, x)
    for a, b in zip(yc, yw):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-12)


def test_soa_matches_aos():
    lat = (2, 4, 2, 4)
    links = TW.random_su3_links(np.random.default_rng(7), lat)
    kw = dict(mass=0.2, c_sw=1.1, links=links, dtype=torch.complex128, device="cpu")
    op_s = TC.wilson_clover_operator(lat, layout="soa", **kw)
    op_a = TC.wilson_clover_operator(lat, layout="aos", **kw)
    _, x = both(crand_np((3, 12) + lat, 8))
    assert_parity(soa_to_aos(TC.apply_clover(op_s, x), 4, 4, 3),
                  TC.apply_clover(op_a, soa_to_aos(x, 4, 4, 3)), np.float64)
