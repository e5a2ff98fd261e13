"""superbblas_tpu_torch.bsr's AoS stencil mode and bsr_krylov against
superbblas_tpu.bsr on the same numpy inputs (f64, rtol 1e-10), with the
cases of tests/test_bsr.py: label orders, alpha/beta/y, operator powers,
spin factors, complex inputs, and SoA operators through bsr_krylov."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, collect_garbage,  # noqa: F401  (fixture)
                           crand_np, to_np)
from superbblas_tpu import bsr as JB
from superbblas_tpu import cplx as JC
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import bsr as TB
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch.models import wilson as TW

pytestmark = pytest.mark.usefixtures("collect_garbage")

RTOL = 1e-10


def stencil_offsets(dim, corners=False):
    """Self + one-hop neighbours along each axis with extent > 1 (as
    tests/test_bsr.py); with ``corners`` the whole {0, +-1}^nd set."""
    if corners:
        return list(itertools.product(*[(0, 1, -1) if d > 2 else (0, 1) for d in dim]))
    offs = [tuple(0 for _ in dim)]
    for ax, d in enumerate(dim):
        if d == 1:
            continue
        for sgn in (1, -1):
            off = [0] * len(dim)
            off[ax] = sgn
            offs.append(tuple(off))
            if d <= 2:
                break
    return offs


def make_ops(dim, BI, BD, seed=0, ones=False, complex_blocks=False, corners=False):
    """The same AoS stencil operator in both packages, labels "XY.."+"s"."""
    offs = stencil_offsets(dim, corners)
    rng = np.random.default_rng(seed)
    shape = tuple(dim) + (len(offs), BI, BD)
    if ones:
        vals = np.ones(shape)
    elif complex_blocks:
        vals = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    else:
        vals = rng.standard_normal(shape)
    lat = "XYZT"[:len(dim)]
    args = (lat + "s", lat + "s", dim, {"s": BI}, {"s": BD}, offs)
    jop = JB.bsr_from_stencil(*args, jnp.asarray(vals) if not complex_blocks
                              else JC.from_complex(vals))
    top = TB.bsr_from_stencil(*args, vals, layout="aos", device="cpu")
    return jop, top, vals, offs


def dense_oracle(dim, offs, vals, x):
    """y[site, i, n] = sum_k vals[site, k] @ x[site+off_k, :, n]."""
    y = np.zeros(tuple(dim) + (vals.shape[-2], x.shape[-1]), dtype=np.result_type(vals, x))
    for site in itertools.product(*[range(d) for d in dim]):
        for k, off in enumerate(offs):
            nb = tuple((s + o) % d for s, o, d in zip(site, off, dim))
            y[site] += vals[site][k] @ x[nb]
    return y


def test_operator_fields_equal_jax():
    jop, top, _, _ = make_ops((4, 3), 2, 3, seed=1)
    assert top.mode == jop.mode == "stencil"
    assert (top.lat_i, top.lat_d, top.blk_i, top.blk_d) == \
        (jop.lat_i, jop.lat_d, jop.blk_i, jop.blk_d)
    assert (top.offsets, top.ndir, top.bi, top.bd) == (jop.offsets, jop.ndir, jop.bi, jop.bd)
    assert top.blocks_im is None and isinstance(top.blocks, torch.Tensor)
    np.testing.assert_array_equal(top.blocks.numpy(), np.asarray(jop.blocks))
    assert TB.bsr_get_preferred_layout(top) == JB.bsr_get_preferred_layout(jop)
    assert top.flops_per_matvec(5, False) == jop.flops_per_matvec(5, False)
    assert top.memops_per_matvec(5, 8) == jop.memops_per_matvec(5, 8)


@pytest.mark.parametrize("case", ["real", "complex_x", "complex_blocks", "corners_4d"])
def test_apply_stencil_no_kron_matches_jax(case):
    """The stacked batched product (one per Gauss term) against JAX's
    dot_general, and against the dense numpy oracle."""
    dim, BI, BD, N = ((2, 3, 2, 4), 3, 3, 2) if case == "corners_4d" else ((4, 3), 2, 3, 5)
    jop, top, vals, offs = make_ops(dim, BI, BD, seed=2,
                                    complex_blocks=case in ("complex_blocks", "corners_4d"),
                                    corners=case == "corners_4d")
    shape = tuple(dim) + (BD, N)
    if case == "real":
        x = np.random.default_rng(3).standard_normal(shape)
        jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
        xo = x
    else:
        parts = crand_np(shape, 3)
        jx, tx = both(parts)
        xo = parts[0] + 1j * parts[1]
    got = TB._apply_stencil(top, tx)
    want = JB._apply_stencil(jop, jx)
    assert_parity(got, want, np.float64, rtol=RTOL)
    got_np = to_np(got) if case == "real" else to_np(got.re) + 1j * to_np(got.im)
    np.testing.assert_allclose(got_np, dense_oracle(dim, offs, vals, xo), rtol=RTOL,
                               atol=RTOL * np.abs(got_np).max())


def test_apply_stencil_kron_matches_jax():
    """Colour then spin per direction, on the AoS Wilson operator."""
    lat = (4, 2, 2, 4)
    jop = JW.wilson_operator(lat, mass=0.3, key=4, dtype=jnp.complex128)
    top = TW.wilson_operator(lat, mass=0.3, key=4, dtype=torch.complex128, layout="aos",
                             device="cpu")
    assert top.mode == "stencil" and top.kron_i == jop.kron_i == "S"
    jx, tx = both(crand_np(lat + (4, 3, 3), 5))
    assert_parity(TB._apply_stencil(top, tx), JB._apply_stencil(jop, jx), np.float64,
                  rtol=RTOL)


def test_fast_check_all_ones():
    """x = 1, blocks = 1 -> every y element = ndir * BD."""
    _, top, _, offs = make_ops((4, 4), 3, 3, ones=True)
    y = TB.bsr_krylov(1.0, top, torch.ones((4, 4, 3, 2), dtype=torch.float64), "XYsn")
    assert torch.all(y == len(offs) * 3)


@pytest.mark.parametrize("case", ["XYsn", "Xcn", "alpha_beta_y", "nXsY_YnsX",
                                  "complex_x", "complex_blocks_carray_y"])
def test_bsr_krylov_matches_jax(case):
    dim, ox, oy = (4, 3), "XYsn", None
    jop, top, _, _ = make_ops(dim, 2, 3, seed=6,
                              complex_blocks=case == "complex_blocks_carray_y")
    rng = np.random.default_rng(7)
    kw_j, kw_t, alpha = {}, {}, 1.0
    x = rng.standard_normal(dim + (3, 5))
    if case == "Xcn":
        dim, ox = (6,), "Xcn"
        offs = stencil_offsets(dim)
        vals = rng.standard_normal(dim + (len(offs), 2, 3))
        jop = JB.bsr_from_stencil("Xc", "Xc", dim, {"c": 2}, {"c": 3}, offs, jnp.asarray(vals))
        top = TB.bsr_from_stencil("Xc", "Xc", dim, {"c": 2}, {"c": 3}, offs, vals,
                                  layout="aos", device="cpu")
        x = rng.standard_normal(dim + (3, 4))
    elif case == "alpha_beta_y":
        alpha = 2.0
        y0 = rng.standard_normal(dim + (2, 5))
        kw_j = dict(beta=-0.5, y=jnp.asarray(y0), oy="XYsn")
        kw_t = dict(beta=-0.5, y=torch.from_numpy(y0), oy="XYsn")
    elif case == "nXsY_YnsX":
        x, ox, oy = np.transpose(x, (3, 0, 2, 1)), "nXsY", "YnsX"
    elif case == "complex_x":
        x = x + 1j * rng.standard_normal(x.shape)
    elif case == "complex_blocks_carray_y":
        y0 = crand_np(dim + (2, 5), 8)
        jy, ty = both(y0)
        kw_j = dict(beta=0.5j, y=jy, oy="XYsn")
        kw_t = dict(beta=0.5j, y=ty, oy="XYsn")
        alpha = 1.5 - 0.5j
    if oy is not None:
        kw_j["oy"] = kw_t["oy"] = oy
    got = TB.bsr_krylov(alpha, top, torch.from_numpy(x.copy()), ox, **kw_t)
    want = JB.bsr_krylov(alpha, jop, jnp.asarray(x), ox, **kw_j)
    if case == "complex_x":
        assert got.is_complex()
        got = TC.from_complex(got)
        want = JC.from_complex(want)
    assert_parity(got, want, np.float64, rtol=RTOL)


@pytest.mark.parametrize("power", [2, 3])
def test_operator_powers_match_jax(power):
    """okr label: y_p = alpha * A^{p+1} x; power read from y when given."""
    jop, top, _, _ = make_ops((4,), 2, 2, seed=10)
    x = np.random.default_rng(11).standard_normal((4, 2, 3))
    got = TB.bsr_krylov(2.0, top, torch.from_numpy(x), "Xsn", oy="Xsnp", okr="p",
                        power=power)
    want = JB.bsr_krylov(2.0, jop, jnp.asarray(x), "Xsn", oy="Xsnp", okr="p", power=power)
    assert got.shape == (4, 2, 3, power)
    assert_parity(got, want, np.float64, rtol=RTOL)
    y0 = np.ones((4, 2, 3, power))
    got = TB.bsr_krylov(2.0, top, torch.from_numpy(x), "Xsn", beta=1.0,
                        y=torch.from_numpy(y0), oy="Xsnp", okr="p")
    want = JB.bsr_krylov(2.0, jop, jnp.asarray(x), "Xsn", beta=1.0, y=jnp.asarray(y0),
                         oy="Xsnp", okr="p")
    assert_parity(got, want, np.float64, rtol=RTOL)


def test_kron_operator_equals_materialized():
    """Kron operator (XYScn) equals the plain BSR with blocks kron(spin,
    colour), and JAX's kron operator."""
    dim = (4, 4)
    offs = stencil_offsets(dim)
    rng = np.random.default_rng(9)
    color = rng.standard_normal(dim + (len(offs), 3, 3))
    spin = rng.standard_normal((len(offs), 2, 2))
    kw = dict(kron_i={"S": 2}, kron_d={"S": 2})
    top = TB.bsr_from_stencil("XYSc", "XYSc", dim, {"c": 3}, {"c": 3}, offs, color,
                              kron=spin, layout="aos", device="cpu", **kw)
    jop = JB.bsr_from_stencil("XYSc", "XYSc", dim, {"c": 3}, {"c": 3}, offs,
                              jnp.asarray(color), kron=jnp.asarray(spin), **kw)
    mats = np.einsum("kab,...kcd->...kacbd", spin, color).reshape(dim + (len(offs), 6, 6))
    plain = TB.bsr_from_stencil("XYz", "XYz", dim, {"z": 6}, {"z": 6}, offs, mats,
                                layout="aos", device="cpu")
    x = rng.standard_normal(dim + (2, 3, 5))
    got = TB.bsr_krylov(1.0, top, torch.from_numpy(x), "XYScn")
    assert_parity(got, JB.bsr_krylov(1.0, jop, jnp.asarray(x), "XYScn"), np.float64,
                  rtol=RTOL)
    flat = TB.bsr_krylov(1.0, plain, torch.from_numpy(x.reshape(dim + (6, 5))), "XYzn")
    np.testing.assert_allclose(got.numpy().reshape(flat.shape), flat.numpy(), rtol=RTOL)


def test_soa_operator_through_bsr_krylov():
    """An SoA operator through bsr_krylov (tests/test_wilson.py:213-233):
    AoS fields through aos_to_soa, and the zero-copy SoA-native order,
    against JAX's SoA and AoS operators; okr powers on the native route."""
    lat = (2, 2, 8, 128)
    jop_a = JW.wilson_operator(lat, mass=0.4, key=7, dtype=jnp.complex128)
    jop_s = JW.wilson_operator(lat, mass=0.4, key=7, dtype=jnp.complex128, layout="soa")
    top = TW.wilson_operator(lat, mass=0.4, key=7, dtype=torch.complex128, layout="soa",
                          device="cpu")
    jx, tx = both(crand_np(lat + (4, 3, 2), 5))
    got = TB.bsr_krylov(1.0, top, tx, "xyztSCn")
    assert_parity(got, JB.bsr_krylov(1.0, jop_s, jx, "xyztSCn"), np.float64, rtol=RTOL)
    assert_parity(got, JB.bsr_krylov(1.0, jop_a, jx, "xyztSCn"), np.float64, rtol=RTOL)
    px, py = TB.bsr_get_preferred_layout(top)
    assert (px, py) == JB.bsr_get_preferred_layout(jop_s)
    perm = ["xyztSCn".index(c) for c in px]
    tx_soa = TC.cmap(lambda a: a.permute(perm).contiguous(), tx)
    jx_soa = JC.cmap(lambda a: jnp.transpose(a, perm), jx)
    got_native = TB.bsr_krylov(1.0, top, tx_soa, px, oy=py)
    assert_parity(got_native, JB.bsr_krylov(1.0, jop_s, jx_soa, px, oy=py), np.float64,
                  rtol=RTOL)
    back = [py.index(c) for c in "xyztScn"]
    assert_parity(TC.cmap(lambda a: a.permute(back), got_native), got, np.float64,
                  rtol=RTOL)
    got_pow = TB.bsr_krylov(1.0, top, tx_soa, px, oy="p" + py, okr="p", power=2)
    want_pow = JB.bsr_krylov(1.0, jop_s, jx_soa, px, oy="p" + py, okr="p", power=2)
    assert_parity(got_pow, want_pow, np.float64, rtol=RTOL)


def test_gather_modes_are_still_to_port():
    for fn in (TB.create_bsr, TB.create_kron_bsr):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn("Xc", (4, 2), "Xc", (4, 2), (1, 2), (1, 2), None, None, None)
    _, top, _, _ = make_ops((4,), 2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        top.replace(mode="gather")
