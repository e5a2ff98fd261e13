"""superbblas_tpu_torch.models.wilson.twisted_mass_operator against the JAX
package's on the same numpy links, in both layouts, and the port's
versions of the JAX package's twisted-mass oracle
(tests/test_models.py::test_twisted_mass_operator)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, collect_garbage, crand_np,  # noqa: F401
                           gamma5_np, materialize, to_np, torch_one_thread)
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import wilson as TW
from superbblas_tpu_torch.ops.stencil import soa_to_aos

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

#: lattices: the JAX package builds SoA operators only where T % 128 == 0
#: and Z % 8 == 0
LATS = {"aos": (2, 2, 2, 4), "soa": (2, 2, 8, 128)}
DTYPES = {np.float64: (jnp.complex128, torch.complex128),
          np.float32: (jnp.complex64, torch.complex64)}
#: f32 results against JAX: 3e-4 of max |y| (the two sum in other orders)
RTOL = {np.float64: None, np.float32: 3e-4}


def field(layout, lat, dtype, seed, n=2):
    shape = (n, 12) + lat if layout == "soa" else lat + (4, 3, n)
    return both(crand_np(shape, seed, dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_matches_jax(layout, dtype):
    lat = LATS[layout]
    links = JW.random_su3_links(np.random.default_rng(5), lat)
    jdt, tdt = DTYPES[dtype]
    jop = JW.twisted_mass_operator(lat, mass=0.2, mu=0.07, links=links, dtype=jdt,
                                   layout=layout)
    top = TW.twisted_mass_operator(lat, mass=0.2, mu=0.07, links=links, dtype=tdt,
                                   layout=layout, device="cpu")
    assert_parity(top.kron, jop.kron, np.float64)
    jx, tx = field(layout, lat, dtype, 1)
    assert_parity(TW.apply_wilson(top, tx), JW.apply_wilson(jop, jx), dtype, RTOL[dtype])


def test_twist_relation_and_gamma5_hermiticity():
    """D_tm = D_W + i mu gamma5 against adding the twist explicitly, and
    gamma5 D_tm(mu) gamma5 = D_tm(-mu)^H; the Wilson operator the twist is
    added to keeps its spin factors."""
    lat, m, mu = (2, 2, 2, 2), 0.2, 0.07
    rng = np.random.default_rng(0)
    links = TW.random_su3_links(rng, lat)
    kw = dict(mass=m, links=links, dtype=torch.complex128, layout="aos", device="cpu")
    op_w = TW.wilson_operator(lat, **kw)
    op_tm = TW.twisted_mass_operator(lat, mu=mu, **kw)
    assert torch.equal(op_w.kron.im[0], torch.zeros(4, 4, dtype=torch.float64))

    xs = [rng.standard_normal(lat + (4, 3, 2)) for _ in range(2)]
    x = CArray(*(torch.from_numpy(a) for a in xs))
    y_tm, y_w = TW.apply_wilson(op_tm, x), TW.apply_wilson(op_w, x)
    g5 = gamma5_np()
    xg = xs[0] + 1j * xs[1]
    want = to_np(y_w.re) + 1j * to_np(y_w.im) + mu * 1j * np.einsum("st,...tcn->...scn",
                                                                     g5, xg)
    np.testing.assert_allclose(to_np(y_tm.re) + 1j * to_np(y_tm.im), want, atol=1e-12)

    D_p = materialize(lambda v: TW.apply_wilson(op_tm, v), lat, (4, 3))
    op_m = TW.twisted_mass_operator(lat, mu=-mu, **kw)
    D_m = materialize(lambda v: TW.apply_wilson(op_m, v), lat, (4, 3))
    G5 = np.kron(np.eye(D_p.shape[0] // 12), np.kron(g5, np.eye(3)))
    np.testing.assert_allclose(G5 @ D_p @ G5, D_m.conj().T, atol=1e-10)


def test_soa_cg_solve_matches_aos():
    """cg_solve on the SoA twisted-mass operator (the stencil kernel's
    plain version, complex centre factor) against cg_solve on the AoS one
    from the same right-hand sides: the same iterates, to 1e-10."""
    lat = (2, 4, 4, 8)
    links = TW.random_su3_links(np.random.default_rng(2), lat)
    kw = dict(mass=0.1, mu=0.05, links=links, dtype=torch.complex128, device="cpu")
    _, tb = field("soa", lat, np.float64, 3)
    x_s, rs_s = TW.cg_solve(TW.twisted_mass_operator(lat, layout="soa", **kw), tb,
                            n_iters=12)
    x_a, rs_a = TW.cg_solve(TW.twisted_mass_operator(lat, layout="aos", **kw),
                            soa_to_aos(tb, 4, 4, 3), n_iters=12)
    assert_parity(soa_to_aos(x_s, 4, 4, 3), x_a, np.float64, 1e-10)
    np.testing.assert_allclose(float(rs_s), float(rs_a), rtol=1e-10)
