"""superbblas_tpu_torch.dense against superbblas_tpu.dense: the cases of
tests/test_dense.py that are not sharded (real, complex and split
operands; cholesky's upper factor and trsm round trips, gesm, inversion,
multi-label rows and columns), the same numpy inputs through both
packages, at f64 (1e-12 relative) and f32 (1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superbblas_tpu import cplx as JC
from superbblas_tpu import dense as JD
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch import dense as TD

from _torch_parity import assert_parity, to_np

MODES = ["real", "complex", "split"]


def hpd_batch(rng, batch, n, complex_=True):
    """Hermitian positive definite matrices [*batch, n, n]."""
    shape = tuple(batch) + (n, n)
    a = rng.standard_normal(shape)
    if complex_:
        a = a + 1j * rng.standard_normal(shape)
    return a @ np.conj(np.swapaxes(a, -1, -2)) + n * np.eye(n)


def both(a, mode, dtype=np.float64):
    """The numpy array ``a`` as the JAX and the port operand of ``mode``."""
    if mode == "split":
        a = a.astype(np.complex64 if dtype == np.float32 else np.complex128)
        return JC.from_complex(a), TC.from_complex(a)
    a = a.astype(dtype if mode == "real" else
                 (np.complex64 if dtype == np.float32 else np.complex128))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def as_np(c):
    if TC.is_carray(c) or JC.is_carray(c):
        return to_np(c.re) + 1j * to_np(c.im)
    if isinstance(c, torch.Tensor):
        return c.numpy()
    return np.asarray(c)


def parity(got, want, dtype):
    if TC.is_carray(got):
        assert JC.is_carray(want)
        assert_parity((got.re, got.im), (want.re, want.im), dtype)
    else:
        g, w = as_np(got), np.asarray(want)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        parts = ((g.real, w.real), (g.imag, w.imag)) if np.iscomplexobj(g) else ((g, w),)
        for gp, wp in parts:
            assert_parity(torch.from_numpy(np.ascontiguousarray(gp)), jnp.asarray(wp), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", MODES)
def test_cholesky_matches_jax(mode, dtype):
    rng = np.random.default_rng(0)
    a = hpd_batch(rng, (2, 3), 4, complex_=(mode != "real"))
    j, t = both(a, mode, dtype)
    u = TD.cholesky(t, "xyrc", "r", "c")
    parity(u, JD.cholesky(j, "xyrc", "r", "c"), dtype)
    un = as_np(u)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(np.conj(np.swapaxes(un, -1, -2)) @ un, a, rtol=tol,
                               atol=tol * np.abs(a).max())
    np.testing.assert_array_equal(np.tril(un, -1), 0)


@pytest.mark.parametrize("mode", MODES)
def test_trsm_of_cholesky_matches_jax(mode):
    rng = np.random.default_rng(1)
    a = hpd_batch(rng, (3,), 4, complex_=(mode != "real"))
    x = rng.standard_normal((3, 4, 5))
    if mode != "real":
        x = x + 1j * rng.standard_normal((3, 4, 5))
    (ja, ta), (jx, tx) = both(a, mode), both(x, mode)
    tu = TD.cholesky(ta, "krc", "r", "c")
    ty = TD.trsm(2.0, tu, "krc", "r", "c", tx, "krn", "kcn")
    ju = JD.cholesky(ja, "krc", "r", "c")
    parity(ty, JD.trsm(2.0, ju, "krc", "r", "c", jx, "krn", "kcn"), np.float64)
    np.testing.assert_allclose(np.einsum("krc,kcn->krn", as_np(tu), as_np(ty)), 2.0 * x,
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mode", MODES)
def test_gesm_matches_jax(mode):
    rng = np.random.default_rng(2)
    a = hpd_batch(rng, (2,), 5, complex_=(mode != "real"))
    a = a + rng.standard_normal(a.shape)          # general, not Hermitian
    x = rng.standard_normal((2, 5, 3))
    if mode != "real":
        x = x + 1j * rng.standard_normal((2, 5, 3))
    (ja, ta), (jx, tx) = both(a, mode), both(x, mode)
    y = TD.gesm(1.0, ta, "krc", "r", "c", tx, "krn", "kcn")
    parity(y, JD.gesm(1.0, ja, "krc", "r", "c", jx, "krn", "kcn"), np.float64)
    np.testing.assert_allclose(np.einsum("krc,kcn->krn", a, as_np(y)), x, rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", MODES)
def test_inversion_matches_jax(mode, dtype):
    rng = np.random.default_rng(3)
    a = hpd_batch(rng, (4,), 3, complex_=(mode != "real"))
    j, t = both(a, mode, dtype)
    inv = TD.inversion(t, "krc", "r", "c")
    parity(inv, JD.inversion(j, "krc", "r", "c"), dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(np.einsum("krc,kcs->krs", a, as_np(inv)),
                               np.broadcast_to(np.eye(3), (4, 3, 3)), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_site_blocks_sc_SC_match_jax(mode):
    """A lattice field of 12x12 site blocks in the order "xyztscSC", rows
    "sc" and columns "SC" (the reference's spin-colour pairs): cholesky,
    trsm of its factor, gesm and inversion, each against JAX."""
    rng = np.random.default_rng(4)
    lat = (2, 2, 1, 2)
    a = hpd_batch(rng, lat, 12, complex_=(mode != "real")).reshape(lat + (4, 3, 4, 3))
    x = rng.standard_normal(lat + (4, 3, 2))
    if mode != "real":
        x = x + 1j * rng.standard_normal(x.shape)
    (ja, ta), (jx, tx) = both(a, mode), both(x, mode)
    o, ox, oy = "xyztscSC", "xyztscn", "xyztSCn"
    tu, ju = TD.cholesky(ta, o, "sc", "SC"), JD.cholesky(ja, o, "sc", "SC")
    parity(tu, ju, np.float64)
    parity(TD.trsm(1.0, tu, o, "sc", "SC", tx, ox, oy),
           JD.trsm(1.0, ju, o, "sc", "SC", jx, ox, oy), np.float64)
    parity(TD.gesm(-0.5, ta, o, "sc", "SC", tx, ox, oy),
           JD.gesm(-0.5, ja, o, "sc", "SC", jx, ox, oy), np.float64)
    parity(TD.inversion(ta, o, "sc", "SC"), JD.inversion(ja, o, "sc", "SC"), np.float64)


def test_embedding_matches_jax():
    """embed_real / extract_embedded give the JAX package's interleaved
    real matrices, and round trip."""
    rng = np.random.default_rng(5)
    c = rng.standard_normal((3, 4, 5)) + 1j * rng.standard_normal((3, 4, 5))
    t2 = TD.embed_real(TC.from_complex(c))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(JD.embed_real(JC.from_complex(c))))
    back = TD.extract_embedded(t2)
    np.testing.assert_array_equal(as_np(back), c)
    m, restore = TD._matrix_view(TC.from_complex(c.reshape(3, 2, 2, 5)), "kabc", "ab", "c")
    assert tuple(m.shape) == (3, 4, 5)
    np.testing.assert_array_equal(as_np(restore(m)), c.reshape(3, 2, 2, 5))
