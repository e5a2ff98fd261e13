"""superbblas_tpu_torch.models.domain_wall (Shamir and Moebius, both
projector sides) against superbblas_tpu.models.domain_wall on the same
numpy links, in both layouts, and the port's versions of the JAX package's
domain-wall oracles (tests/test_models.py), the Moebius CGNE solve among
them with the JAX package's iteration count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, collect_garbage, crand_np,  # noqa: F401
                           gamma5_np, to_np, torch_one_thread)
from superbblas_tpu import cplx as JCX
from superbblas_tpu import solvers as JSOL
from superbblas_tpu.models import domain_wall as JD
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import solvers
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import domain_wall as TD
from superbblas_tpu_torch.models import wilson as TW

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

#: the JAX package builds SoA operators only where T % 128 == 0, Z % 8 == 0
LATS = {"aos": (2, 2, 2, 4), "soa": (2, 2, 8, 128)}
DTYPES = {np.float64: (jnp.complex128, torch.complex128),
          np.float32: (jnp.complex64, torch.complex64)}
#: f32 results against JAX: 3e-4 of max |y| (the two sum in other orders)
RTOL = {np.float64: None, np.float32: 3e-4}
LS = 4


def builders(kind, side="right"):
    """(JAX builder, port builder, keyword arguments) of one family."""
    if kind == "shamir":
        return JD.domain_wall_operator, TD.domain_wall_operator, dict(M5=1.8, m_f=0.1)
    return JD.mobius_operator, TD.mobius_operator, dict(
        M5=1.8, m_f=0.1, b5=1.5, c5=0.5, projector_side=side)


def field(layout, lat, dtype, seed, n=2, Ls=LS):
    shape = (n, Ls, 12) + lat if layout == "soa" else (Ls,) + lat + (4, 3, n)
    return both(crand_np(shape, seed, dtype))


@pytest.mark.parametrize("Ls", [1, LS, 12])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("layout", ["aos", "soa"])
@pytest.mark.parametrize("kind,side", [("shamir", "right"), ("mobius", "right"),
                                       ("mobius", "left")])
def test_matches_jax(kind, side, layout, dtype, Ls):
    """The s wrap's mass walls at s = 0 and s = Ls-1 included; at Ls 1 the
    two walls meet in one slice."""
    lat = LATS[layout]
    links = JW.random_su3_links(np.random.default_rng(9), lat)
    jb, tb, kw = builders(kind, side)
    jdt, tdt = DTYPES[dtype]
    jop = jb(lat, Ls=Ls, links=links, dtype=jdt, layout=layout, **kw)
    top = tb(lat, Ls=Ls, links=links, dtype=tdt, layout=layout, device="cpu", **kw)
    if layout == "aos":
        assert top.ndir == {"shamir": 11, "mobius": 27}[kind]
        assert_parity(top.blocks, jop.blocks, np.float64)
    else:
        assert isinstance(top, TD.DomainWallSoAOperator) and top.mobius == (kind == "mobius")
        assert top.flops_per_matvec(2) == jop.flops_per_matvec(2)
        for a, b in ((top.pp_diag, jop.pp_diag), (top.pm_diag, jop.pm_diag)):
            np.testing.assert_array_equal(to_np(a), to_np(b))
    jx, tx = field(layout, lat, dtype, 1, Ls=Ls)
    assert_parity(TD.apply_domain_wall(top, tx), JD.apply_domain_wall(jop, jx), dtype,
                  RTOL[dtype])


def to_aos(v):
    """SoA [n, Ls, 12, *lat] -> AoS [Ls, *lat, 4, 3, n]."""
    n, ls = v.re.shape[:2]
    lat = tuple(v.re.shape[3:])
    return CArray(*(p.reshape((n, ls, 4, 3) + lat).permute(1, 4, 5, 6, 7, 2, 3, 0)
                    for p in v))


@pytest.mark.parametrize("Ls", [1, LS, 12])
@pytest.mark.parametrize("kind,side", [("shamir", "right"), ("mobius", "right"),
                                       ("mobius", "left")])
def test_soa_matches_aos(kind, side, Ls):
    lat = (2, 2, 4, 4)
    links = TW.random_su3_links(np.random.default_rng(10), lat)
    _, tb, kw = builders(kind, side)
    kw.update(Ls=Ls, links=links, device="cpu")
    _, x = field("soa", lat, np.float64, 2, n=3, Ls=Ls)
    assert_parity(to_aos(TD.apply_domain_wall(tb(lat, layout="soa", **kw), x)),
                  TD.apply_domain_wall(tb(lat, layout="aos", **kw), to_aos(x)),
                  np.float64)


def dense(op, lat, Ls):
    """Dense matrix of an AoS domain-wall operator."""
    n = Ls * int(np.prod(lat)) * 12
    eye = torch.eye(n, dtype=torch.float64).reshape((Ls,) + lat + (4, 3, n))
    y = TD.apply_domain_wall(op, CArray(eye, torch.zeros_like(eye)))
    return (to_np(y.re) + 1j * to_np(y.im)).reshape(n, n)


def g5r5(lat, Ls):
    R5 = np.eye(Ls)[::-1]
    return np.kron(R5, np.kron(np.eye(int(np.prod(lat))), np.kron(gamma5_np(), np.eye(3))))


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_reduces_to_wilson_at_ls1(layout):
    """Ls = 1: both s5 wrap links land on the centre, so D_dw is the
    Wilson operator at mass 1 - M5 + m_f."""
    lat, M5, mf = (2, 2, 2, 2), 1.3, 0.07
    rng = np.random.default_rng(0)
    links = TW.random_su3_links(rng, lat)
    dw = TD.domain_wall_operator(lat, Ls=1, M5=M5, m_f=mf, links=links, layout=layout,
                                 device="cpu")
    w = TW.wilson_operator(lat, mass=1.0 - M5 + mf, links=links, dtype=torch.complex128,
                           layout=layout, device="cpu")
    shape = (2, 1, 12) + lat if layout == "soa" else (1,) + lat + (4, 3, 2)
    _, x = both(crand_np(shape, 1))
    y_dw = TD.apply_domain_wall(dw, x)
    pick = (lambda a: a[:, 0]) if layout == "soa" else (lambda a: a[0])
    y_w = TW.apply_wilson(w, CArray(pick(x.re), pick(x.im)))
    for a, b in zip(y_dw, y_w):
        np.testing.assert_allclose(to_np(pick(a)), to_np(b), atol=1e-12)


def test_r5g5_hermiticity():
    """Gamma5 R5 D R5 Gamma5 = D^H for Shamir."""
    lat, Ls = (2, 2, 2, 2), 4
    dw = TD.domain_wall_operator(lat, Ls=Ls, M5=1.6, m_f=0.1, key=2, layout="aos",
                                 device="cpu")
    D, S = dense(dw, lat, Ls), g5r5(lat, Ls)
    np.testing.assert_allclose(S @ D @ S, D.conj().T, atol=1e-10)


def test_mobius_reduces_to_shamir():
    """Moebius at b5 = 1, c5 = 0 (27 offsets less the 16 zero corners) is
    Shamir's 11-offset stencil."""
    lat, Ls = (2, 2, 2, 4), 4
    rng = np.random.default_rng(8)
    links = TW.random_su3_links(rng, lat)
    kw = dict(Ls=Ls, M5=1.7, m_f=0.08, links=links, layout="aos", device="cpu")
    dw = TD.domain_wall_operator(lat, **kw)
    mb = TD.mobius_operator(lat, b5=1.0, c5=0.0, **kw)
    x = torch.from_numpy(rng.standard_normal((Ls,) + lat + (4, 3, 2))
                         + 1j * rng.standard_normal((Ls,) + lat + (4, 3, 2)))
    np.testing.assert_allclose(TD.apply_domain_wall(mb, x).numpy(),
                               TD.apply_domain_wall(dw, x).numpy(), rtol=1e-10, atol=1e-10)


def test_mobius_r5g5_adjoint_pair():
    """(Gamma5 R5) D_right (Gamma5 R5) = D_left^H, and Moebius at c5 != 0
    is not Gamma5-R5-Hermitian by itself."""
    lat, Ls = (2, 2, 2, 2), 4
    links = TW.random_su3_links(np.random.default_rng(3), lat)
    kw = dict(Ls=Ls, M5=1.6, m_f=0.1, b5=1.4, c5=0.4, links=links, layout="aos",
              device="cpu")
    Dr = dense(TD.mobius_operator(lat, **kw), lat, Ls)
    Dl = dense(TD.mobius_operator(lat, projector_side="left", **kw), lat, Ls)
    S = g5r5(lat, Ls)
    np.testing.assert_allclose(S @ Dr @ S, Dl.conj().T, atol=1e-10)
    assert np.abs(S @ Dr @ S - Dr.conj().T).max() > 1e-3


def test_mobius_cgne_solve_matches_jax():
    """The Moebius CGNE solve with A^H = (Gamma5 R5) D_left (Gamma5 R5):
    the adjoint identity, then the solve to 1e-10, with JAX's iteration
    count and answer at f64 (tests/test_models.py's case, AoS)."""
    lat, Ls = (2, 2, 2, 4), 4
    rng = np.random.default_rng(19)
    links = JW.random_su3_links(rng, lat)
    kw = dict(Ls=Ls, M5=1.4, m_f=0.3, b5=1.5, c5=0.5, links=links, layout="aos")
    Dr = TD.mobius_operator(lat, device="cpu", **kw)
    Dl = TD.mobius_operator(lat, projector_side="left", device="cpu", **kw)
    g5 = torch.from_numpy(np.real(gamma5_np()))

    def G(v):
        return CArray(*(torch.einsum("st,...tcn->...scn", g5, p.flip(0)) for p in v))

    A = lambda v: TD.apply_domain_wall(Dr, v)            # noqa: E731
    Ah = lambda v: G(TD.apply_domain_wall(Dl, G(v)))     # noqa: E731
    shape = (Ls,) + lat + (4, 3, 1)
    jb, b = both((rng.standard_normal(shape), rng.standard_normal(shape)))
    _, u = both((rng.standard_normal(shape), rng.standard_normal(shape)))
    cx = lambda v: to_np(v.re) + 1j * to_np(v.im)       # noqa: E731
    np.testing.assert_allclose(np.vdot(cx(u), cx(A(b))), np.vdot(cx(Ah(u)), cx(b)),
                               rtol=1e-10)
    x, rs, it = solvers.cgne(A, Ah, b, tol=1e-10, maxiter=600)
    r = A(x)
    assert float(sum(((p - q) ** 2).sum() for p, q in zip(r, b))
                 / sum((q ** 2).sum() for q in b)) < 1e-8

    jDr = JD.mobius_operator(lat, **kw)
    jDl = JD.mobius_operator(lat, projector_side="left", **kw)
    jg5 = jnp.asarray(np.real(gamma5_np()))

    def jG(v):
        return JCX.cmap(lambda a: jnp.einsum("st,...tcn->...scn", jg5, a[::-1]), v)

    jx, _, jit = JSOL.cgne(lambda v: JD.apply_domain_wall(jDr, v),
                           lambda v: jG(JD.apply_domain_wall(jDl, jG(v))), jb, tol=1e-10,
                           maxiter=600)
    assert it == int(jit)
    assert_parity(x, jx, np.float64, 1e-8)
