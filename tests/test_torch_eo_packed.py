"""superbblas_tpu_torch.models.eo_packed (SoA part) and .even_odd against
superbblas_tpu.models.eo_packed / .even_odd on the same numpy inputs, and
the packed plain stencil against a site-by-site numpy oracle on ragged
half lattices."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (WILSON_OFFSETS, assert_parity, both, crand_np, to_np,
                           torch_one_thread, collect_garbage)  # noqa: F401  (fixtures)
from superbblas_tpu import cplx as JC
from superbblas_tpu.models import eo_packed as JE
from superbblas_tpu.models import even_odd as JO
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import bsr as TB
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch.models import eo_packed as TE
from superbblas_tpu_torch.models import even_odd as TO
from superbblas_tpu_torch.models import wilson as TW
from superbblas_tpu_torch.ops import stencil as TS

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

# the JAX package builds SoA operators only where T % 128 == 0 and Z % 8 == 0
LAT = (4, 2, 8, 128)
HOPPING = WILSON_OFFSETS[1:]


def ops(dtype=jnp.complex128, lat=LAT, mass=0.1, key=0):
    """The JAX SoA Wilson operator and the port's, carried across by
    operator_from_numpy."""
    jop = JW.wilson_operator(lat, mass=mass, key=key, layout="soa", dtype=dtype)
    a = np.asarray
    top = TB.operator_from_numpy(a(jop.blocks.re), a(jop.blocks.im), a(jop.kron.re),
                                 a(jop.kron.im), jop.offsets, jop.dim_i, jop.bi, jop.bd,
                                 jop.ki, jop.kd, device="cpu")
    return jop, top


@pytest.mark.parametrize("shape", [(2, 12) + LAT, (3, 2, 6, 3, 5, 7)])
def test_cb_pack_unpack_match_jax_exactly(shape):
    j, t = both(crand_np(shape, 0))
    packed = []
    for parity in (0, 1):
        got, want = TE.cb_pack_soa(t, parity), JE.cb_pack_soa(j, parity)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), to_np(w))
        packed.append((got, want))
    back = TE.cb_unpack_soa(packed[0][0], packed[1][0])
    for g, w, orig in zip(back, JE.cb_unpack_soa(packed[0][1], packed[1][1]), t):
        np.testing.assert_array_equal(to_np(g), to_np(w))
        assert torch.equal(g, orig)


def test_cb_pack_keeps_the_storage_dtype():
    _, t = both(crand_np((2, 9) + (4, 2, 2, 4), 1), tdtype=torch.bfloat16)
    assert TE.cb_pack_soa(t, 1).re.dtype == torch.bfloat16


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("parity", [0, 1])
def test_hopping_blocks_equal_jax_exactly(parity, adjoint):
    jop, top = ops()
    if adjoint:
        jop, top = JW.adjoint_operator(jop), TW.adjoint_operator(top)
    jh, th = JE.hopping_packed_soa(jop, parity), TE.hopping_packed_soa(top, parity)
    for j, t in ((jh.blocks.re, th.blocks_re), (jh.blocks.im, th.blocks_im),
                 (jh.kron.re, th.kron_re), (jh.kron.im, th.kron_im)):
        assert t.numpy().dtype == np.asarray(j).dtype == np.float64
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    sign = -1 if adjoint else 1
    assert th.offsets == jh.offsets == tuple(tuple(sign * o for o in off) for off in HOPPING)
    assert th.dim_i == th.dim_d == tuple(jh.dim_d) == (LAT[0] // 2,) + LAT[1:]


def test_hopping_needs_even_x_and_one_hot_offsets():
    _, top = ops()
    with pytest.raises(ValueError, match="even"):
        TE.hopping_packed_soa(top.replace(dim=(3,) + LAT[1:]), 0)
    with pytest.raises(ValueError, match="one-hot"):
        TE._check_one_hot([(0, 1, 1, 0)])


@pytest.mark.parametrize("parity", [0, 1])
def test_apply_hopping_matches_jax_reference(parity):
    jop, top = ops()
    jx, tx = both(crand_np((2, 12, LAT[0] // 2) + LAT[1:], 2 + parity))
    got = TE.apply_hopping_packed_soa(TE.hopping_packed_soa(top, parity), tx, parity)
    want = JE.apply_hopping_packed_soa(JE.hopping_packed_soa(jop, parity), jx, parity)
    assert_parity(got, want, np.float64)


def test_apply_hopping_matches_jax_pallas_kernel():
    """The port's packed hopping (plain version on the CPU) against the
    TPU kernel with packed_parity itself, in Pallas interpret mode."""
    lat = (4, 4, 8, 128)
    jop, top = ops(jnp.complex64, lat=lat)
    jx, tx = both(crand_np((2, 12, 2) + lat[1:], 4, np.float32))
    got = TE.apply_hopping_packed_soa(TE.hopping_packed_soa(top, 1), tx, 1)
    want = JE.apply_hopping_packed_soa(JE.hopping_packed_soa(jop, 1), jx, 1,
                                       interpret=True)
    assert_parity(got, want, np.float32)


def test_bf16_storage_and_fields_match_jax():
    """bf16 links and fields flow through the packing: the port converts on
    load and rounds the output to bf16, so it matches JAX applying the same
    bf16-rounded values in f32 to one bf16 ulp (2^-7) of max |y|."""
    jop, top = ops(jnp.complex64)
    hop = TE.hopping_packed_soa(TB.bsr_cast_storage(top, torch.bfloat16), 0)
    assert hop.blocks_re.dtype == torch.bfloat16 and hop.kron_re.dtype == torch.float32
    _, tx = both(crand_np((2, 12, LAT[0] // 2) + LAT[1:], 5, np.float32),
                 tdtype=torch.bfloat16)
    got = TE.apply_hopping_packed_soa(hop, tx, 0)
    assert got.re.dtype == torch.bfloat16
    jhop = dataclasses.replace(JE.hopping_packed_soa(jop, 0), blocks=JC.CArray(
        jnp.asarray(to_np(hop.blocks_re), jnp.float32),
        jnp.asarray(to_np(hop.blocks_im), jnp.float32)))
    jx = JC.CArray(*(jnp.asarray(to_np(p), jnp.float32) for p in tx))
    assert_parity(got, JE.apply_hopping_packed_soa(jhop, jx, 0), np.float32, rtol=8e-3)


def test_eo_solve_matches_jax():
    """20 Schur CG iterations, 1 right-hand side, f64: psi and |r|^2."""
    jop, top = ops()
    jb, tb = both(crand_np((1, 12) + LAT, 6))
    a = 0.1 + 4.0
    tpsi, trs = TE.eo_solve_packed_soa(top, tb, a=a, n_iters=20)
    jpsi, jrs = JE.eo_solve_packed_soa(jop, jb, a=a, n_iters=20)
    assert_parity(tpsi, jpsi, np.float64, rtol=1e-10)
    assert trs.ndim == 0 and trs.dtype == torch.float64
    np.testing.assert_allclose(float(trs), float(jrs), rtol=1e-10)


def test_eo_solve_solves_the_full_system():
    """The packed solve's psi satisfies D psi = b (full-lattice operator,
    plain version), f64."""
    lat, mass = (4, 2, 2, 4), 0.5
    top = TW.wilson_operator(lat, mass=mass, key=3, dtype=torch.complex128, layout="soa",
                          device="cpu")
    _, b = both(crand_np((2, 12) + lat, 7))
    psi, rs = TE.eo_solve_packed_soa(top, b, a=mass + 4.0, n_iters=60)
    r = TC.add(TW.apply_wilson(top, psi), TC.scale(-1.0, b))
    rel = (float(TC.inner_real(r, r)) / float(TC.inner_real(b, b))) ** 0.5
    assert rel < 1e-10 and float(rs) < 1e-18


def test_packed_hopping_adjoint_identity():
    """<y_e, H_eo x_o> = <(H^H)_oe y_e, x_o>: the packed hopping of the
    adjoint operator is the adjoint of the packed hopping."""
    lat = (4, 2, 4, 6)
    top = TW.wilson_operator(lat, key=1, dtype=torch.complex128, layout="soa", device="cpu")
    half = (2, 12, lat[0] // 2) + lat[1:]
    _, x = both(crand_np(half, 8))
    _, y = both(crand_np(half, 9))
    hx = TE.apply_hopping_packed_soa(TE.hopping_packed_soa(top, 0), x, 0)
    hy = TE.apply_hopping_packed_soa(
        TE.hopping_packed_soa(TW.adjoint_operator(top), 1), y, 1)

    def inner(a, b):
        return complex(TC.inner_real(a, b), float((a.re * b.im - a.im * b.re).sum()))

    lhs, rhs = inner(y, hx), inner(hy, x)
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def _numpy_packed_stencil(blocks, kron, x, offsets, parity):
    """Site-by-site oracle of the packed stencil: image site (xh, y, z, t)
    of parity p, m = (p + y + z + t) % 2; +x reads slot xh+1 when m, else
    xh; -x reads xh when m, else xh-1 (both wrapped); Y/Z/T shift."""
    n, _, *lat = x.shape
    y = np.zeros((n, 12) + tuple(lat), complex)
    for site in itertools.product(*[range(v) for v in lat]):
        m = (parity + sum(site[1:])) % 2
        for d, off in enumerate(offsets):
            nb = list(site)
            for ax, o in enumerate(off):
                if o == 0:
                    continue
                if ax == 0:
                    step = (1 if m else 0) if o > 0 else (0 if m else -1)
                    nb[0] = (site[0] + step) % lat[0]
                else:
                    nb[ax] = (site[ax] + o) % lat[ax]
            xv = x[(slice(None), slice(None)) + tuple(nb)].reshape(n, 4, 3)
            z = np.einsum("ab,nbj->naj", kron[d], xv)
            blk = blocks[(d, slice(None)) + site].reshape(3, 3)
            y[(slice(None), slice(None)) + site] += np.einsum(
                "ij,naj->nai", blk, z).reshape(n, 12)
    return y


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("half", [(1, 3, 2, 5), (3, 3, 1, 4)])
def test_packed_plain_version_matches_numpy_oracle(half, parity):
    """Ragged half lattices (X/2 of 1 and 3, odd Y and T), kron spin
    factors, 8 hopping directions, f64: the wrapper's CPU path."""
    bre, bim = crand_np((8, 9) + half, 10)
    kre, kim = crand_np((8, 4, 4), 11)
    xre, xim = crand_np((2, 12) + half, 12)
    got = TS.stencil_matvec_soa(TC.CArray(torch.from_numpy(bre), torch.from_numpy(bim)),
                                TC.CArray(torch.from_numpy(kre), torch.from_numpy(kim)),
                                TC.CArray(torch.from_numpy(xre), torch.from_numpy(xim)),
                                HOPPING, 3, 3, packed_parity=parity)
    want = _numpy_packed_stencil(bre + 1j * bim, kre + 1j * kim, xre + 1j * xim,
                                 HOPPING, parity)
    np.testing.assert_allclose(to_np(got.re) + 1j * to_np(got.im), want,
                               rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_checkerboard_masks_match_jax():
    even, odd = TO.checkerboard_masks((4, 3, 2), 2, device="cpu")
    jeven, jodd = JO.checkerboard_masks((4, 3, 2), 2)
    assert even.dtype == torch.float32 and tuple(even.shape) == (4, 3, 2, 1, 1)
    np.testing.assert_array_equal(to_np(even), to_np(jeven))
    np.testing.assert_array_equal(to_np(odd), to_np(jodd))


@pytest.mark.parametrize("split", [True, False])
def test_schur_cg_matches_jax(split):
    """schur_cg over dense non-Hermitian matrices, on CArrays and on plain
    complex tensors, f64."""
    rng = np.random.default_rng(13)
    N = 24
    D = 3 * np.eye(N) + (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))) / N
    b = rng.standard_normal((N, 2)) + 1j * rng.standard_normal((N, 2))
    Dt, Dht = torch.from_numpy(D), torch.from_numpy(D.conj().T.copy())

    if split:
        def ap(M, v):
            z = M @ torch.complex(v.re, v.im)
            return TC.CArray(z.real.contiguous(), z.imag.contiguous())

        def jap(M, v):
            z = jnp.asarray(M) @ (v.re + 1j * v.im)
            return JC.CArray(z.real, z.imag)

        jb, tb = both((b.real.copy(), b.imag.copy()))
    else:
        ap, jap = (lambda M, v: M @ v), (lambda M, v: jnp.asarray(M) @ v)
        jb, tb = jnp.asarray(b), torch.from_numpy(b)
    tx, trs = TO.schur_cg(lambda v: ap(Dt, v), lambda v: ap(Dht, v), tb, 12)
    jx, jrs = JO.schur_cg(lambda v: jap(D, v), lambda v: jap(D.conj().T, v), jb, 12)
    if split:
        assert_parity(tx, jx, np.float64, rtol=1e-10)
    else:
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(trs), float(jrs), rtol=1e-10)
