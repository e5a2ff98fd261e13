"""superbblas_tpu_torch's AoS even-odd functions (``models.even_odd``:
``schur_matvec``, ``eo_solve``; ``models.eo_packed``: ``cb_pack``,
``cb_unpack``, ``hopping_packed``, ``apply_hopping_packed``,
``eo_solve_packed``) against superbblas_tpu's on the same numpy links and
fields, at f64 (relative 1e-12; the solves' |r_e|^2 within 1e-10 of the
JAX package's, at the same fixed iteration count), on the cases of
tests/test_models.py: the eo_solve residual (:126), the packing round trip
(:177), the packed hopping against the masked one (:189), the packed
solve's residual (:220) and the staggered packed hopping (:310)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import collect_garbage, to_np, torch_one_thread  # noqa: F401  (fixtures)
from superbblas_tpu import cplx as JC
from superbblas_tpu.models import eo_packed as JE
from superbblas_tpu.models import even_odd as JO
from superbblas_tpu.models import staggered as JS
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch.models import eo_packed as TE
from superbblas_tpu_torch.models import even_odd as TO
from superbblas_tpu_torch.models import staggered as TS
from superbblas_tpu_torch.models import wilson as TW

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

RTOL = 1e-12
RS_TOL = 1e-10
LAT = (4, 4, 2, 2)


def close(got, want, rtol=RTOL):
    """Port result against the JAX one (split complex or plain), relative
    to the largest reference entry."""
    gp = tuple(got) if TC.is_carray(got) else (got,)
    wp = tuple(want) if JC.is_carray(want) else (want,)
    assert len(gp) == len(wp)
    scale = max(float(np.abs(to_np(w)).max()) for w in wp)
    for g, w in zip(gp, wp):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=rtol, atol=rtol * scale)


def wilson_pair(lat=LAT, mass=0.4, seed=5):
    links = TW.random_su3_links(np.random.default_rng(seed), lat)
    jop = JW.wilson_operator(lat, mass=mass, links=links, dtype=jnp.complex128)
    top = TW.wilson_operator(lat, mass=mass, links=links, dtype=torch.complex128,
                             device="cpu")
    return jop, top


def staggered_pair(lat, mass=0.3, seed=6):
    links = TW.random_su3_links(np.random.default_rng(seed), lat)
    jop = JS.staggered_operator(lat, mass=mass, links=links, dtype=jnp.complex128)
    top = TS.staggered_operator(lat, mass=mass, links=links, dtype=torch.complex128,
                                device="cpu")
    return jop, top


def field(shape, seed):
    rng = np.random.default_rng(seed)
    re, im = rng.standard_normal(shape), rng.standard_normal(shape)
    return (JC.CArray(jnp.asarray(re), jnp.asarray(im)),
            TC.CArray(torch.from_numpy(re), torch.from_numpy(im)))


def test_aos_operators_have_the_reference_structure():
    jop, top = wilson_pair()
    assert top.mode == jop.mode == "stencil" and top.offsets == jop.offsets
    close(top.blocks, jop.blocks)
    close(top.kron, jop.kron)


@pytest.mark.parametrize("ncols", [1, 3])
def test_schur_matvec_matches_jax(ncols):
    jop, top = wilson_pair(mass=0.3, seed=7)
    a = 0.3 + 4.0
    jx, tx = field(LAT + (4, 3, ncols), 1)
    je, jo = JO.checkerboard_masks(LAT, 3)
    te, to = TO.checkerboard_masks(LAT, 3, device="cpu")
    jv, tv = JO._mask(je, jx), TO._mask(te, tx)
    close(TO.schur_matvec(top, a, te, to, tv), JO.schur_matvec(jop, a, je, jo, jv))
    jh, th = JW.adjoint_operator(jop), TW.adjoint_operator(top)
    close(TO._schur_matvec_dagger(th, a, te, to, tv),
          JO._schur_matvec_dagger(jh, a, je, jo, jv))


@pytest.mark.parametrize("solver", ["eo_solve", "eo_solve_packed"])
def test_eo_solves_match_jax_and_solve(solver):
    """tests/test_models.py:126 and :220: the 4x4x2x2 Wilson operator at
    mass 0.4, 60 Schur CG iterations: psi against the JAX package's, the
    Schur |r_e|^2 alike, and |D psi - b| / |b| < 1e-8."""
    jop, top = wilson_pair()
    a = 0.4 + 4.0
    jb, tb = field(LAT + (4, 3, 1), 8)
    jfn = JO.eo_solve if solver == "eo_solve" else JE.eo_solve_packed
    tfn = TO.eo_solve if solver == "eo_solve" else TE.eo_solve_packed
    keys = set(vars(top))
    jpsi, jrs = jfn(jop, jb, a=a, n_iters=60)
    tpsi, trs = tfn(top, tb, a=a, n_iters=60)
    assert set(vars(top)) == keys, "the solve left a memo on the operator"
    close(tpsi, jpsi)
    assert abs(float(trs) - float(jrs)) <= RS_TOL * max(1.0, float(jrs))
    r = TW.apply_wilson(top, tpsi)
    rel = (sum(float(((p - q) ** 2).sum()) for p, q in zip(r, tb))
           / sum(float((q ** 2).sum()) for q in tb)) ** 0.5
    assert rel < 1e-8, rel


@pytest.mark.parametrize("solver", ["eo_solve", "eo_solve_packed"])
def test_eo_solves_take_complex_tensors(solver):
    """A complex tensor ``b`` gives a complex psi equal to the split solve."""
    _, top = wilson_pair(mass=0.5, seed=9)
    a = 0.5 + 4.0
    _, tb = field(LAT + (4, 3, 2), 10)
    fn = TO.eo_solve if solver == "eo_solve" else TE.eo_solve_packed
    want, rs = fn(top, tb, a=a, n_iters=12)
    got, rs_c = fn(top, TC.to_complex(tb), a=a, n_iters=12)
    assert got.is_complex() and tuple(got.shape) == LAT + (4, 3, 2)
    np.testing.assert_allclose(got.real.numpy(), want.re.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.imag.numpy(), want.im.numpy(), rtol=1e-12, atol=1e-12)
    assert abs(float(rs_c) - float(rs)) <= RS_TOL * max(1.0, float(rs))


@pytest.mark.parametrize("shape,nlat", [((8, 4, 2, 6, 3), 4), ((4, 6, 2, 5), 2)])
def test_cb_pack_unpack_match_jax(shape, nlat):
    """tests/test_models.py:177: both parities against the JAX package's,
    and the round trip exact."""
    a = np.random.default_rng(0).standard_normal(shape)
    ta = torch.from_numpy(a)
    for parity in (0, 1):
        np.testing.assert_array_equal(TE.cb_pack(ta, nlat, parity).numpy(),
                                      np.asarray(JE.cb_pack(jnp.asarray(a), nlat, parity)))
    back = TE.cb_unpack(TE.cb_pack(ta, nlat, 0), TE.cb_pack(ta, nlat, 1), nlat)
    assert torch.equal(back, ta)
    c = TC.CArray(ta, 2 * ta)
    back = TE.cb_unpack(TE.cb_pack(c, nlat, 0), TE.cb_pack(c, nlat, 1), nlat)
    assert torch.equal(back.re, c.re) and torch.equal(back.im, c.im)


@pytest.mark.parametrize("to_parity", [0, 1])
def test_packed_hopping_matches_jax_and_masked(to_parity):
    """tests/test_models.py:189: the packed Wilson hopping H onto each
    parity against the JAX package's and against the masked P H P on the
    full lattice; ``hopping_packed`` halves X on both lattices."""
    jop, top = wilson_pair(mass=0.3, seed=7)
    a = 0.3 + 4.0
    jx, tx = field(LAT + (4, 3, 2), 1)
    jhop, thop = JE.hopping_packed(jop, to_parity), TE.hopping_packed(top, to_parity)
    assert thop.dim_i == thop.dim_d == (2,) + LAT[1:] and thop.offsets == jhop.offsets
    close(thop.blocks, jhop.blocks)
    src = 1 - to_parity
    got = TE.apply_hopping_packed(thop, TE.cb_pack(tx, 4, src), to_parity)
    close(got, JE.apply_hopping_packed(jhop, JE.cb_pack(jx, 4, src), to_parity))
    te, to = TO.checkerboard_masks(LAT, 3, device="cpu")
    m_to, m_from = (te, to) if to_parity == 0 else (to, te)
    x_from = TO._mask(m_from, tx)
    hx = TC.add(TW.apply_wilson(top, x_from), TC.scale(-a, x_from))
    want = TE.cb_pack(TO._mask(m_to, hx), 4, to_parity)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)


def test_staggered_packed_hopping_matches_jax_and_masked():
    """tests/test_models.py:310: the packed machinery on the (no-kron)
    staggered operator, a 4x4 lattice: against the JAX package and the
    masked hopping."""
    lat, m = (4, 4), 0.3
    jop, top = staggered_pair(lat, mass=m)
    jx, tx = field(lat + (3, 2), 4)
    jhop, thop = JE.hopping_packed(jop, 0), TE.hopping_packed(top, 0)
    got = TE.apply_hopping_packed(thop, TE.cb_pack(tx, 2, 1), 0)
    close(got, JE.apply_hopping_packed(jhop, JE.cb_pack(jx, 2, 1), 0))
    te, to = TO.checkerboard_masks(lat, 2, device="cpu")
    x_o = TO._mask(to, tx)
    hx = TC.add(TS.apply_staggered(top, x_o), TC.scale(-m, x_o))
    want = TE.cb_pack(TO._mask(te, hx), 2, 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)


def test_staggered_eo_solve_packed_matches_jax():
    """The packed solve of the no-kron staggered operator on a 4^4 lattice
    (the canonical operand [X/2, *rest, BD, N]): psi and |r_e|^2 against
    the JAX package's at the same iteration count."""
    lat, m = (4, 4, 4, 4), 0.5
    jop, top = staggered_pair(lat, mass=m, seed=11)
    jb, tb = field(lat + (3, 2), 12)
    jpsi, jrs = JE.eo_solve_packed(jop, jb, a=m, n_iters=20)
    tpsi, trs = TE.eo_solve_packed(top, tb, a=m, n_iters=20)
    close(tpsi, jpsi)
    assert abs(float(trs) - float(jrs)) <= RS_TOL * max(1.0, float(jrs))


def test_packing_refusals():
    """An odd X, a non-AoS operator and offsets other than one-hot +-1
    raise, as in the JAX package."""
    _, top = wilson_pair()
    with pytest.raises(ValueError, match="even"):
        TE.hopping_packed(top.replace(dim=(3, 4, 2, 2)), 0)
    soa = TW.wilson_operator(LAT, mass=0.4, dtype=torch.complex128, layout="soa",
                             device="cpu")
    with pytest.raises(ValueError, match="AoS"):
        TE.hopping_packed(soa, 0)
    with pytest.raises(ValueError, match="one-hot"):
        TE.hopping_packed(top.replace(offsets=((0, 0, 0, 0),) + ((1, 1, 0, 0),) * 8), 0)
