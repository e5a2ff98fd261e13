"""superbblas_tpu_torch.models.multigrid against
superbblas_tpu.models.multigrid on the same operators and seeds (c128,
1e-10 unless stated): the prolongators, the Galerkin coarse matrix and
coarse BSR operator, a three-level V-cycle, multigrid on the unsquared
operator inside FGCR with the JAX package's iteration count, the SoA
level apply against the AoS one, and CholeskyQR2 against numpy's QR."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, collect_garbage, crand_np,  # noqa: F401
                           to_np, torch_one_thread)  # noqa: F401  (fixtures)
from superbblas_tpu import solvers as JS
from superbblas_tpu.models import multigrid as JM
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch import solvers as TS
from superbblas_tpu_torch.models import coarse as TCo
from superbblas_tpu_torch.models import multigrid as TM
from superbblas_tpu_torch.models import wilson as TW

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

RTOL = 1e-10


def wilson_ops(lat, mass, layout="aos"):
    jop = JW.wilson_operator(lat, mass=mass, key=3, dtype=jnp.complex128)
    top = TW.wilson_operator(lat, mass=mass, key=3, dtype=torch.complex128,
                             layout=layout, device="cpu")
    return jop, top


def to_c(a):
    return to_np(a.re) + 1j * to_np(a.im)


def test_two_grid_matches_jax():
    """build_prolongator, coarse_matrix, coarse_bsr_operator and the
    two-grid cycle against JAX; the port's own oracles: block-orthonormal
    P, Hermitian A_c, Galerkin exactness (an error in range(P) dies in one
    coarse correction) and the coarse BSR apply equal to the dense A_c."""
    jop, top = wilson_ops((4, 4, 4, 4), 0.05)
    jP, tP = JM.build_prolongator(jop, K=4, setup_iters=10), \
        TM.build_prolongator(top, K=4, setup_iters=10)
    assert_parity(tP, jP, np.float64, rtol=RTOL)
    pm = to_c(tP)
    g = np.einsum("...di,...dj->...ij", pm.conj(), pm)
    assert np.abs(g - np.eye(4)).max() < 1e-12
    jA, tA = JM.coarse_matrix(jop, jP), TM.coarse_matrix(top, tP)
    assert_parity(tA, jA, np.float64, rtol=RTOL)
    ac = to_c(tA)
    assert np.abs(ac - ac.conj().T).max() < 1e-10

    jx, tx = both(crand_np((4,) * 4 + (4, 3), 1))
    jprec = JM.two_grid_preconditioner(jop, jP, jA, omega=0.1)
    tprec = TM.two_grid_preconditioner(top, tP, tA, omega=0.1)
    assert_parity(tprec(tx), jprec(jx), np.float64, rtol=RTOL)
    rho = TM.two_grid_error_contraction(top, tP, tA, omega=0.1)
    assert abs(rho - JM.two_grid_error_contraction(jop, jP, jA, omega=0.1)) < 1e-10

    c = TC.CArray(*(torch.from_numpy(p) for p in crand_np((2,) * 4 + (4,), 0)))
    e = TM._prolong(tP, c, (2, 2, 2, 2))
    corr = TM.two_grid_preconditioner(top, tP, tA)(TM._A_normal(top, e))
    rel = np.linalg.norm(to_c(e) - to_c(corr)) / np.linalg.norm(to_c(e))
    assert rel < 1e-10, rel

    cop = TM.coarse_bsr_operator(top, tP, A_c=tA)
    jcop = JM.coarse_bsr_operator(jop, jP, A_c=jA)
    assert cop.mode == "stencil" and cop.offsets == jcop.offsets and cop.bd == (4,)
    assert_parity(cop.blocks, jcop.blocks, np.float64, rtol=RTOL)
    cv = TC.CArray(*(torch.from_numpy(p) for p in crand_np((2,) * 4 + (4, 1), 2)))
    got = to_c(TCo.apply_coarse(cop, cv))
    want = (ac @ to_c(cv).reshape(-1)).reshape(got.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_vcycle_matches_jax():
    """build_hierarchy(levels=3) on 8x8x4x4: the fine Wilson level, a 4x4x2x2
    coarse BSR level with 36 offsets (K = 4) and a 2x2x1x1 one; one V-cycle
    application (Chebyshev degree 4) against JAX's at 1e-9."""
    jop, top = wilson_ops((8, 8, 4, 4), 0.2)
    jh = JM.build_hierarchy(jop, levels=3, K=4, setup_iters=6)
    th = TM.build_hierarchy(top, levels=3, K=4, setup_iters=6)
    for (jo, jP, jA, jb, jn), (to, tP, tA, tb, tn) in zip(jh, th):
        assert (tb, tn, to.dim_d) == (jb, jn, tuple(jo.dim_d))
        assert_parity(tP, jP, np.float64, rtol=1e-9)
        assert_parity(tA, jA, np.float64, rtol=1e-9)
    assert th[1][0].mode == "stencil" and th[1][0].ndir == 36 and th[2][0].ndir == 4
    jx, tx = both(crand_np((8, 8, 4, 4, 4, 3, 2), 5))
    got = TM.vcycle_preconditioner(th, cheby_degree=4)(tx)
    want = JM.vcycle_preconditioner(jh, cheby_degree=4)(jx)
    assert_parity(got, want, np.float64, rtol=1e-9)


def test_mg_on_unsquared_operator_matches_jax():
    """Chiral prolongator + LU coarse solve + GCR smoothing inside FGCR on D
    at mass -1.8 (tests/test_multigrid.py:374-428): the JAX package's
    iteration count, the same answer, and the port's own CGNE answer."""
    lat = (4, 4, 4, 4)
    jop, top = wilson_ops(lat, -1.8)
    jP = JM.build_prolongator_chiral(jop, K=4, setup_iters=8)
    tP = TM.build_prolongator_chiral(top, K=4, setup_iters=8)
    assert_parity(tP, jP, np.float64, rtol=RTOL)
    cols = to_c(TM._unaggregate(TC.cmap(lambda a: a.reshape(a.shape[:4] + (a.shape[4], 8)),
                                        tP), (2, 2, 2, 2)))
    assert np.abs(cols[..., 2:, :, :4]).max() < 1e-12
    assert np.abs(cols[..., :2, :, 4:]).max() < 1e-12
    jA, tA = JM.coarse_matrix(jop, jP, normal=False), TM.coarse_matrix(top, tP, normal=False)
    assert_parity(tA, jA, np.float64, rtol=RTOL)
    jb, tb = both(crand_np(lat + (4, 3, 2), 1))
    jx, _, jk = JS.fgcr(lambda u: JW.apply_wilson(jop, u), jb,
                        M=JM.mg_preconditioner_d(jop, jP, jA, smooth_steps=4),
                        tol=1e-9, maxiter=400, restart=8, cols=True)
    tx, _, tk = TS.fgcr(lambda u: TW.apply_wilson(top, u), tb,
                        M=TM.mg_preconditioner_d(top, tP, tA, smooth_steps=4),
                        tol=1e-9, maxiter=400, restart=8, cols=True)
    assert tk == int(jk)
    assert_parity(tx, jx, np.float64, rtol=1e-8)
    xn, _, kn = TS.cg(lambda u: TM._A_normal(top, u), TW.apply_wilson_dagger(top, tb),
                      tol=1e-9, maxiter=20000, cols=True)
    assert np.abs(to_c(tx) - to_c(xn)).max() < 1e-5
    # D-applies: outer (1) + cycle (2 * 4 + 2) an iteration against CGNE's 2
    assert tk * 11 * 2 < 2 * kn, (tk, kn)


@pytest.mark.parametrize("normal", [False, True])
def test_level_apply_soa_matches_aos(normal):
    """The SoA level apply (stencil kernel's layout, AoS<->SoA at the
    boundary) against the AoS one on the same links, and against JAX."""
    lat = (2, 2, 4, 8)
    links = TW.random_su3_links(np.random.default_rng(5), lat)
    kw = dict(mass=-1.0, links=links, dtype=torch.complex128, device="cpu")
    op_a = TW.wilson_operator(lat, layout="aos", **kw)
    op_s = TW.wilson_operator(lat, layout="soa", **kw)
    jop = JW.wilson_operator(lat, mass=-1.0, links=links, dtype=jnp.complex128)
    jx, tx = both(crand_np(lat + (4, 3, 2), 6))
    ys = TM._level_apply(op_s, tx, normal=normal)
    assert_parity(ys, TM._level_apply(op_a, tx, normal=normal), np.float64, rtol=RTOL)
    assert_parity(ys, JM._level_apply(jop, jx, normal=normal), np.float64, rtol=RTOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_block_cholqr_matches_host_qr(dtype):
    """Orthonormal columns spanning the input's column space, held against
    np.linalg.qr through the projector Q Q^H.  f64: columns spread over 6
    orders of magnitude (cond ~1e6), 1e-10 / 1e-8 as the reference test;
    f32: a well-conditioned input (cond <= 1e2), 1e-4 (CholeskyQR2 at f32
    holds only to cond ~ 1/sqrt(eps), open fault F3)."""
    rng = np.random.default_rng(7)
    B, dof, K = 5, 48, 8
    a = rng.standard_normal((B, dof, K)) + 1j * rng.standard_normal((B, dof, K))
    if dtype == np.float64:
        a = a * np.logspace(0, -6, K)[None, None, :]
        tol_g, tol_p = 1e-10, 1e-8
    else:
        a = a * np.logspace(0, -1, K)[None, None, :]
        tol_g = tol_p = 1e-4
    assert np.linalg.cond(a).max() < (1e7 if dtype == np.float64 else 1e2)
    q = TM._block_cholqr(TC.CArray(torch.from_numpy(a.real.astype(dtype)),
                                   torch.from_numpy(a.imag.astype(dtype))))
    assert q.re.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    qm = to_c(q)
    assert np.abs(np.einsum("bdi,bdj->bij", qm.conj(), qm) - np.eye(K)).max() < tol_g
    q_host = np.linalg.qr(a)[0]
    p_dev = np.einsum("bdi,bei->bde", qm, qm.conj())
    p_host = np.einsum("bdi,bei->bde", q_host, q_host.conj())
    assert np.abs(p_dev - p_host).max() < tol_p


def test_chebyshev_smoother_minimax():
    """The smoother's error polynomial |1 - t p(t)| hits the Chebyshev
    minimax bound 1/cosh(d acosh(sigma)) on the band."""
    lam, theta = 1.0, 30.0
    ts = torch.linspace(lam / theta, lam, 2001, dtype=torch.float64)
    sigma = (lam + lam / theta) / (lam - lam / theta)
    for degree in (2, 4, 6):
        S = TM.chebyshev_smoother(lambda v: TC.CArray(ts * v.re, ts * v.im), lam,
                                  degree=degree, theta=theta)
        x = S(TC.CArray(torch.ones_like(ts), torch.zeros_like(ts)))
        err = float((1.0 - ts * x.re).abs().max())
        np.testing.assert_allclose(err, 1.0 / np.cosh(degree * np.arccosh(sigma)), rtol=1e-6)
