"""superbblas_tpu_torch.models.staggered against superbblas_tpu.models.staggered
on the same numpy links, in both layouts, and the port's versions of the
JAX package's staggered oracles (tests/test_models.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, collect_garbage, crand_np,  # noqa: F401
                           materialize, torch_one_thread)
from superbblas_tpu.models import staggered as JS
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import solvers
from superbblas_tpu_torch.models import staggered as TS
from superbblas_tpu_torch.models import wilson as TW

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

#: the JAX package builds SoA operators only where T % 128 == 0, Z % 8 == 0
LATS = {"aos": (2, 2, 2, 4), "soa": (2, 2, 8, 128)}
DTYPES = {np.float64: (jnp.complex128, torch.complex128),
          np.float32: (jnp.complex64, torch.complex64)}
#: f32 results against JAX: 3e-4 of max |y| (the two sum in other orders)
RTOL = {np.float64: None, np.float32: 3e-4}


@pytest.mark.parametrize("lat", [(4, 4), (2, 3, 4, 5)])
def test_eta_phases_match_jax(lat):
    np.testing.assert_array_equal(TS.eta_phases(lat), JS.eta_phases(lat))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_matches_jax(layout, dtype):
    """Same links, same operator: blocks and applies agree.  The SoA
    operator is the stencil kernel's (KI, KD, BI, BD) = (1, 1, 3, 3) case
    with 9 directions."""
    lat = LATS[layout]
    links = JW.random_su3_links(np.random.default_rng(4), lat)
    jdt, tdt = DTYPES[dtype]
    jop = JS.staggered_operator(lat, mass=0.3, links=links, dtype=jdt, layout=layout)
    top = TS.staggered_operator(lat, mass=0.3, links=links, dtype=tdt, layout=layout,
                                device="cpu")
    assert top.kron is None and top.ndir == 9 and top.bi == top.bd == (3,)
    assert_parity(top.blocks, jop.blocks, np.float64)
    shape = (2, 3) + lat if layout == "soa" else lat + (3, 2)
    jx, tx = both(crand_np(shape, 1, dtype))
    assert_parity(TS.apply_staggered(top, tx), JS.apply_staggered(jop, jx), dtype,
                  RTOL[dtype])


def test_antihermitian_hopping():
    """D + D^H = 2m I: the hopping part is anti-Hermitian."""
    lat, m = (4, 4), 0.25
    op = TS.staggered_operator(lat, mass=m, key=1, dtype=torch.complex128, layout="aos",
                               device="cpu")
    D = materialize(lambda x: TS.apply_staggered(op, x), lat, (3,))
    np.testing.assert_allclose(D + D.conj().T, 2 * m * np.eye(D.shape[0]), atol=1e-12)


def test_soa_matches_aos_and_cgne_matches_cg_solve():
    """The SoA apply equals the AoS apply; CGNE through ``solvers.cgne``
    with ``adjoint_operator`` (the staggered solve's form) makes the
    iterates of ``cg_solve`` on the same operator."""
    lat = (2, 4, 4, 8)
    links = TW.random_su3_links(np.random.default_rng(6), lat)
    kw = dict(mass=0.2, links=links, dtype=torch.complex128, device="cpu")
    op_s = TS.staggered_operator(lat, layout="soa", **kw)
    op_a = TS.staggered_operator(lat, layout="aos", **kw)
    _, x = both(crand_np((3, 3) + lat, 2))
    to_aos = lambda v: type(v)(*(p.permute(2, 3, 4, 5, 1, 0) for p in v))  # noqa: E731
    assert_parity(to_aos(TS.apply_staggered(op_s, x)),
                  TS.apply_staggered(op_a, to_aos(x)), np.float64)
    op_h = TW.adjoint_operator(op_s)
    xs, rs, it = solvers.cgne(lambda v: TS.apply_staggered(op_s, v),
                              lambda v: TS.apply_staggered(op_h, v), x, tol=0.0,
                              maxiter=10)
    xc, rc = TW.cg_solve(op_s, x, n_iters=10)
    assert it == 10
    assert_parity(xs, xc, np.float64, 1e-10)
    np.testing.assert_allclose(float(rs), float(rc), rtol=1e-10)
