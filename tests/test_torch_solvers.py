"""superbblas_tpu_torch.solvers against superbblas_tpu.solvers at f64 on
the same numpy inputs: equal iteration counts, results within 1e-10.

Operators: seeded dense complex matrices acting on AoS-shaped CArrays
[4, 4, 6, ncols] (the trailing axis holds the columns with ``cols``), a
Hermitian positive-definite one for cg/pcg/lanczos and a non-Hermitian
one for bicgstab/fgcr; and the small SoA Wilson operator for cgne.  The
solves converge in far fewer iterations than the 96 dimensions, where
Krylov iterates stay well-conditioned functions of their inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, crand_np, to_np,
                           torch_one_thread, collect_garbage)  # noqa: F401  (fixtures)
from superbblas_tpu import cplx as JC
from superbblas_tpu import solvers as JS
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch import solvers as TS
from superbblas_tpu_torch.models import wilson as TW

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

FIELD = (4, 4, 6)
NV = 96
NCOLS = 3
RTOL = 1e-10


def _matrix(kind, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((NV, NV)) + 1j * rng.standard_normal((NV, NV))) / np.sqrt(NV)
    if kind == "hpd":
        return a @ a.conj().T + np.eye(NV)
    if kind == "few":   # Hermitian with 3 distinct eigenvalues: Lanczos breaks down
        q, _ = np.linalg.qr(a)
        return q @ np.diag(np.repeat([1.0, 2.0, 5.0], NV // 3)) @ q.conj().T
    return 2.0 * np.eye(NV) + a


def _applies(M):
    """The same matrix as a port apply and a JAX apply on CArray fields
    FIELD + (ncols,)."""
    Mt = torch.from_numpy(M)

    def t(v):
        z = (Mt @ torch.complex(v.re, v.im).reshape(NV, -1)).reshape(v.re.shape)
        return TC.CArray(z.real.contiguous(), z.imag.contiguous())

    def j(v):
        z = (jnp.asarray(M) @ (v.re + 1j * v.im).reshape(NV, -1)).reshape(v.re.shape)
        return JC.CArray(z.real, z.imag)

    return t, j


def _jacobi(M):
    """Jacobi preconditioner r -> r / diag(M) for both packages."""
    d = (1.0 / np.diag(M)).reshape(FIELD + (1,))
    dt = TC.CArray(torch.from_numpy(d.real.copy()), torch.from_numpy(d.imag.copy()))
    dj = JC.CArray(jnp.asarray(d.real), jnp.asarray(d.imag))

    def t(r):
        return TC.CArray(dt.re * r.re - dt.im * r.im, dt.re * r.im + dt.im * r.re)

    def j(r):
        return JC.CArray(dj.re * r.re - dj.im * r.im, dj.re * r.im + dj.im * r.re)

    return t, j


def _rhs(seed=1):
    return both(crand_np(FIELD + (NCOLS,), seed))


def _check(tout, jout, b):
    """(x, |r|^2, iterations) of the port against JAX's.  A converged
    recursive residual is a difference of O(|b|) terms, each rounded to
    about 1e-16 |b|: its norm is compared to 1e-12 of |b|."""
    (tx, trs, tk), (jx, jrs, jk) = tout, jout
    assert isinstance(tk, int) and tk == int(jk)
    assert_parity(tx, jx, np.float64, rtol=RTOL)
    bn = float(TC.inner_real(b, b)) ** 0.5
    np.testing.assert_allclose(np.sqrt(to_np(trs)), np.sqrt(to_np(jrs)), rtol=RTOL,
                               atol=1e-12 * bn)
    return tk


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("cols", [False, True])
def test_cg_matches_jax(cols, x0):
    t, j = _applies(_matrix("hpd"))
    jb, tb = _rhs()
    kw = dict(tol=1e-9, maxiter=200, cols=cols)
    jx0, tx0 = both(crand_np(FIELD + (NCOLS,), 2)) if x0 else (None, None)
    k = _check(TS.cg(t, tb, x0=tx0, **kw), JS.cg(j, jb, x0=jx0, **kw), tb)
    assert 0 < k < 200


@pytest.mark.parametrize("cols", [False, True])
def test_pcg_jacobi_matches_jax(cols):
    M = _matrix("hpd", 3)
    t, j = _applies(M)
    mt, mj = _jacobi(M)
    jb, tb = _rhs()
    kw = dict(tol=1e-9, maxiter=200, cols=cols)
    out = TS.pcg(t, mt, tb, **kw)
    assert tuple(out[1].shape) == ((NCOLS,) if cols else ())
    assert 0 < _check(out, JS.pcg(j, mj, jb, **kw), tb) < 200


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("cols", [False, True])
def test_fgcr_matches_jax(cols, precond):
    M = _matrix("general", 4)
    t, j = _applies(M)
    mt, mj = _jacobi(M) if precond else (None, None)
    jb, tb = _rhs()
    kw = dict(tol=1e-9, maxiter=64, restart=4, cols=cols)
    k = _check(TS.fgcr(t, tb, M=mt, **kw), JS.fgcr(j, jb, M=mj, **kw), tb)
    assert 0 < k < 64 and k % 4 == 0


@pytest.mark.parametrize("x0", [False, True])
def test_bicgstab_matches_jax(x0):
    t, j = _applies(_matrix("general", 5))
    jb, tb = _rhs()
    jx0, tx0 = both(crand_np(FIELD + (NCOLS,), 6)) if x0 else (None, None)
    k = _check(TS.bicgstab(t, tb, x0=tx0, tol=1e-9, maxiter=100),
               JS.bicgstab(j, jb, x0=jx0, tol=1e-9, maxiter=100), tb)
    assert 0 < k < 100


def test_cgne_wilson_normal_operator_matches_jax():
    """CG on D^H D x = D^H b with the small SoA Wilson operator, f64."""
    lat = (2, 2, 8, 128)
    jop = JW.wilson_operator(lat, mass=1.0, key=0, layout="soa", dtype=jnp.complex128)
    top = TW.wilson_operator(lat, mass=1.0, key=0, dtype=torch.complex128, device="cpu")
    jop_h, top_h = JW.adjoint_operator(jop), TW.adjoint_operator(top)
    jb, tb = both(crand_np((1, 12) + lat, 7))
    kw = dict(tol=1e-8, maxiter=100)
    k = _check(TS.cgne(lambda v: TW.apply_wilson(top, v),
                       lambda v: TW.apply_wilson(top_h, v), tb, **kw),
               JS.cgne(lambda v: JW.apply_wilson(jop, v),
                       lambda v: JW.apply_wilson(jop_h, v), jb, **kw), tb)
    assert 0 < k < 100


def test_power_iteration_matches_jax():
    t, j = _applies(_matrix("hpd", 8))
    jx, tx = _rhs(9)
    tlam, tv = TS.power_iteration(t, tx, iters=40)
    jlam, jv = JS.power_iteration(j, jx, iters=40)
    np.testing.assert_allclose(float(tlam), float(jlam), rtol=RTOL)
    assert_parity(tv, jv, np.float64, rtol=RTOL)


@pytest.mark.parametrize("kind", ["hpd", "few"])
def test_lanczos_and_ritz_extremes_match_jax(kind):
    """Lanczos coefficients and Ritz extremes; "few" has three distinct
    eigenvalues, so the recurrence breaks down after three steps and
    freezes."""
    M = _matrix(kind, 10)
    t, j = _applies(M)
    jx, tx = _rhs(11)
    ta, tb_ = TS.lanczos(t, tx, m=12)
    ja, jb_ = JS.lanczos(j, jx, m=12)
    assert tuple(ta.shape) == (12,) and tuple(tb_.shape) == (11,)
    scale = float(np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(to_np(ta), to_np(ja), rtol=RTOL, atol=RTOL * scale)
    np.testing.assert_allclose(to_np(tb_), to_np(jb_), rtol=RTOL, atol=RTOL * scale)
    tlo, thi = TS.ritz_extremes(ta, tb_)
    jlo, jhi = JS.ritz_extremes(ja, jb_)
    np.testing.assert_allclose([tlo, thi], [jlo, jhi], rtol=RTOL)
    if kind == "few":
        assert float(tb_[3:].abs().max()) == 0.0
        np.testing.assert_allclose([tlo, thi], [1.0, 5.0], rtol=1e-8)


def test_refined_solve_over_inner_cg_matches_jax():
    t, j = _applies(_matrix("hpd", 12))
    jb, tb = _rhs(13)
    tx, trs = TS.refined_solve(t, lambda r: TS.cg(t, r, tol=1e-3, maxiter=4)[0], tb,
                               cycles=3)
    jx, jrs = JS.refined_solve(j, lambda r: JS.cg(j, r, tol=1e-3, maxiter=4)[0], jb,
                               cycles=3)
    assert_parity(tx, jx, np.float64, rtol=RTOL)
    np.testing.assert_allclose(float(trs), float(jrs), rtol=RTOL)
