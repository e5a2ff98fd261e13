"""Aggregation multigrid for lattice operators (counterpart of
``superbblas_tpu/models/multigrid.py``).

  1. near-null setup: smooth K random vectors with Richardson iterations
     of the level operator (damps high modes, leaves the near-kernel);
  2. aggregation: block the lattice into 2^4-site aggregates and
     block-orthonormalise the vectors within each (CholeskyQR2) to form
     the prolongator P (fine dof x K per aggregate);
  3. Galerkin coarse operator A_c = P^H A P, built densely from one
     batched apply of the level operator to all coarse basis columns;
  4. cycles: the two-grid correction with a dense coarse solve
     (``torch.linalg`` Cholesky or LU of the real embedding), the
     multigrid cycle on the unsquared D for flexible GCR, and the
     recursive V-cycle over coarse BSR operators (``coarse_bsr_operator``),
     whose applies run on the batched-GEMM kernels.

Fields are split-complex CArrays in the canonical AoS order
[*lat, *blk(, N)], a trailing column axis optional.  Fine SoA operators
are applied through the stencil kernel with AoS<->SoA conversion at the
boundary.  Random draws come from numpy seeded as in the JAX package and
are moved to the operator's device.  The JAX package's ``jit``/``fori_loop``
programs are Python loops here.

The SoA Wilson-clover operator has a two-level multigrid of its own, with
no JAX counterpart (:func:`clover_mg_setup`, :func:`mg_cycle`,
:func:`mg_solve_clover`): the fine level stays in the SoA layout [n, 12,
*lat] and is applied by ``apply_clover``; the test vectors are made
near-null by inverse iterations (GCR on D, then the built cycle), split
by chirality and block-orthonormalised on the aggregates; the Galerkin
operator P^H D P is probed into a coarse BSR operator (mode "gather",
one 2K x 2K block a coarse site and offset) on the operator's device,
with no dense A_c; the cycle smooths by a few GCR steps on D and solves
the coarse system by a few GCR steps on that operator's batched-GEMM
apply, neither reading the device.  Its spans
``mg.cycle`` and ``mg.coarse`` and counters ``mg.cycles`` and
``mg.coarse_iterations`` go to the tracker; the coarse and smoothing
iterations never count as ``solver.iterations``.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cplx
from ..bsr import BSROperator, _apply_stencil, apply_stencil_soa, bsr_from_stencil
from ..cplx import CArray
from ..labels import volume
from ..ops.stencil import aos_to_soa, soa_to_aos
from ..solvers import fgcr, power_iteration
from ..utils import tracker
from .clover import CloverOperator, apply_clover
from .coarse import apply_coarse
from .wilson import _inner, adjoint_operator

__all__ = ["build_prolongator", "coarse_matrix", "coarse_bsr_operator",
           "two_grid_preconditioner", "symmetric_two_grid_preconditioner",
           "two_grid_error_contraction", "chebyshev_smoother",
           "build_hierarchy", "vcycle_preconditioner",
           "build_prolongator_chiral", "mg_preconditioner_d",
           "CloverMG", "clover_mg_setup", "galerkin_coarse_operator", "mg_cycle",
           "mg_solve_clover"]


def _blk_shape(op: BSROperator) -> Tuple[int, ...]:
    """Canonical per-site block shape: (KD, BD) for Kronecker operators
    (Wilson: (4, 3)), (BD,) for plain stencils (coarse BSR: (K,))."""
    if op.kron_re is not None:
        return (volume(op.kd), volume(op.bd))
    return (volume(op.bd),)


def _randn(op: BSROperator, rng: np.random.Generator, shape) -> CArray:
    """A split-complex normal field drawn from ``rng`` (real part, then
    imaginary part, as the JAX package draws them), on the operator's
    device in its field precision (at least f32)."""
    dt = torch.promote_types(op.blocks_re.dtype, torch.float32)
    return CArray(*(torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                                    device=op.blocks_re.device) for _ in range(2)))


def _level_apply(op, x, normal: bool = True, op_h: Optional[BSROperator] = None):
    """The level's operator on canonical fields [*lat, *blk(, N)]: A = D^H D
    at the fine level (``normal=True``; ``op_h`` is D's adjoint, built when
    None); Galerkin coarse operators are applied directly
    (``normal=False``).  SoA operators run the stencil kernel with
    AoS<->SoA conversion at the boundary, so the whole cycle rides it;
    so does an SoA ``CloverOperator`` (``apply_clover``, D^H = g5 D g5)."""
    if isinstance(op, CloverOperator):
        return _clover_level_apply(op, x, normal)
    blk = _blk_shape(op)
    squeeze = x.ndim == 4 + len(blk)
    if squeeze:
        x = cplx.cmap(lambda a: a[..., None], x)
    if normal and op_h is None:
        op_h = adjoint_operator(op)
    if op.mode == "stencil_soa":
        if op.kron_re is None or len(blk) != 2:
            raise ValueError("SoA multigrid levels need a Kronecker (spin x colour) "
                             "operator")
        y = apply_stencil_soa(op, aos_to_soa(x, 4))
        if normal:
            y = apply_stencil_soa(op_h, y)
        y = soa_to_aos(y, 4, volume(op.ki), volume(op.bi))
    else:
        y = _apply_stencil(op, x)
        if normal:
            y = _apply_stencil(op_h, y)
    return cplx.cmap(lambda a: a[..., 0], y) if squeeze else y


def _g5(v: CArray) -> CArray:
    """g5 = diag(1, 1, -1, -1) on the spins of SoA fields [n, 12, *lat]."""
    sign = torch.ones(12, dtype=v.re.dtype, device=v.re.device)
    sign[6:] = -1.0
    sign = sign.reshape((1, 12) + (1,) * (v.re.ndim - 2))
    return cplx.cmap(lambda a: a * sign, v)


def _clover_level_apply(op: CloverOperator, x, normal: bool):
    """``_level_apply`` of an SoA clover operator on canonical fields
    [*lat, 4, 3(, N)]."""
    if op.hop.mode != "stencil_soa":
        raise ValueError("the clover multigrid level needs layout='soa'")
    squeeze = x.ndim == 6
    if squeeze:
        x = cplx.cmap(lambda a: a[..., None], x)
    y = apply_clover(op, aos_to_soa(x, 4))
    if normal:
        y = _g5(apply_clover(op, _g5(y)))
    y = soa_to_aos(y, 4, 4, 3)
    return cplx.cmap(lambda a: a[..., 0], y) if squeeze else y


def _level_fn(op, normal: bool) -> Callable:
    """``x -> _level_apply(op, x, normal)`` with D's adjoint built once."""
    op_h = adjoint_operator(op) if normal else None
    return lambda x: _level_apply(op, x, normal, op_h)


def _A_normal(op, x):
    """The fine-level normal operator D^H D."""
    return _level_apply(op, x, normal=True)


def _aggregate(x: CArray, block: Tuple[int, ...], n_blk: int = 2) -> CArray:
    """[*lat, *blk(, N)] -> [*clat, dof(, N)], dof = prod(block)*prod(blk)
    (``n_blk`` = number of per-site block axes)."""
    def ag(v):
        lat, rest = v.shape[:4], tuple(v.shape[4:])
        c = [d // b for d, b in zip(lat, block)]
        v = v.reshape((c[0], block[0], c[1], block[1], c[2], block[2],
                       c[3], block[3]) + rest)
        v = torch.movedim(v, (1, 3, 5, 7), (4, 5, 6, 7))
        dof = volume(block) * volume(rest[:n_blk])
        return v.reshape(tuple(c) + (dof,) + rest[n_blk:])
    return cplx.cmap(ag, x)


def _unaggregate(x: CArray, block: Tuple[int, ...], sc=(4, 3)) -> CArray:
    """[*clat, dof(, N)] -> [*lat, *sc(, N)], the inverse of _aggregate."""
    def ua(v):
        c, rest = tuple(v.shape[:4]), tuple(v.shape[5:])
        v = v.reshape(c + tuple(block) + tuple(sc) + rest)
        v = torch.movedim(v, (4, 5, 6, 7), (1, 3, 5, 7))
        lat = tuple(ci * b for ci, b in zip(c, block))
        return v.reshape(lat + tuple(sc) + rest)
    return cplx.cmap(ua, x)


def _block_cholqr(agg: CArray, passes: int = 2) -> CArray:
    """Batched thin QR of [*batch, dof, K] split-complex aggregate blocks
    (CholeskyQR2): per pass form the K x K Gram G = A^H A, factor G = L L^H
    with a K-unrolled split-complex recurrence, and forward-substitute
    A <- A L^{-H}.  As in the JAX package a non-positive pivot is clamped
    to 1e-30 rather than reported (open fault F3 of ROADMAP.md), so at f32
    orthonormality holds only for well-conditioned bases (cond well under
    1/sqrt(eps))."""
    K = agg.shape[-1]

    def gram(a, b):
        with cplx._full_f32():
            return torch.einsum("...dk,...dl->...kl", a, b)

    def one_pass(q: CArray) -> CArray:
        qre, qim = q.re, q.im
        # Gram G[k,l] = sum_d conj(Q[d,k]) Q[d,l]  -> [*batch, K, K]
        gre = gram(qre, qre) + gram(qim, qim)
        gim = gram(qre, qim) - gram(qim, qre)
        # split-complex Cholesky G = L L^H, unrolled over the small K
        Lre = [[None] * K for _ in range(K)]
        Lim = [[None] * K for _ in range(K)]
        for j in range(K):
            s = gre[..., j, j]
            for k in range(j):
                s = s - (Lre[j][k] * Lre[j][k] + Lim[j][k] * Lim[j][k])
            d = torch.sqrt(torch.clamp_min(s, 1e-30))
            Lre[j][j] = d
            for i in range(j + 1, K):
                sre = gre[..., i, j]
                sim = gim[..., i, j]
                for k in range(j):
                    # subtract L[i,k] * conj(L[j,k])
                    sre = sre - (Lre[i][k] * Lre[j][k] + Lim[i][k] * Lim[j][k])
                    sim = sim - (Lim[i][k] * Lre[j][k] - Lre[i][k] * Lim[j][k])
                Lre[i][j] = sre / d
                Lim[i][j] = sim / d
        # forward substitution Q L^H = A:
        #   Q[:,j] = (A[:,j] - sum_{k<j} Q[:,k] conj(L[j,k])) / L[j,j]
        qn_re, qn_im = [], []
        for j in range(K):
            nre, nim = qre[..., j], qim[..., j]
            for k in range(j):
                a = Lre[j][k][..., None]
                b = Lim[j][k][..., None]
                nre = nre - (qn_re[k] * a + qn_im[k] * b)
                nim = nim - (qn_im[k] * a - qn_re[k] * b)
            d = Lre[j][j][..., None]
            qn_re.append(nre / d)
            qn_im.append(nim / d)
        return CArray(torch.stack(qn_re, dim=-1), torch.stack(qn_im, dim=-1))

    q = agg
    for _ in range(passes):
        q = one_pass(q)
    return q


def _smooth_near_null(A: Callable, v: CArray, setup_iters: int) -> CArray:
    """``setup_iters`` weighted-Richardson steps v <- v - omega A v, omega =
    0.8 / lambda_max(A) from 20 power iterations on v's first column."""
    lam, _ = power_iteration(A, cplx.cmap(lambda a: a[..., :1], v), iters=20)
    omega = 0.8 / torch.clamp_min(lam, 1e-30)
    for _ in range(setup_iters):
        av = A(v)
        v = CArray(v.re - omega * av.re, v.im - omega * av.im)
    return v


def build_prolongator(op: BSROperator, block=(2, 2, 2, 2), K: int = 4,
                      setup_iters: int = 8, key=0, normal: bool = True) -> CArray:
    """Near-null aggregation prolongator P: CArray [*clat, dof, K] with
    block-orthonormal columns (P^H P = I per aggregate), on the operator's
    device."""
    blk = _blk_shape(op)
    v = _randn(op, np.random.default_rng(key), tuple(op.dim_d) + blk + (K,))
    v = _smooth_near_null(_level_fn(op, normal), v, setup_iters)
    return _block_cholqr(_aggregate(v, block, n_blk=len(blk)))


def _prolong(P: CArray, c: CArray, block, sc=(4, 3)) -> CArray:
    """coarse [*clat, K(, N)] -> fine [*lat, *sc(, N)]."""
    x = cplx.cdot_general(P, c, (((5,), (4,)), ((0, 1, 2, 3), (0, 1, 2, 3))))
    return _unaggregate(x, block, sc)


def _restrict(P: CArray, x: CArray, block, n_blk: int = 2) -> CArray:
    """fine -> coarse: P^H x per aggregate."""
    ax = _aggregate(x, block, n_blk=n_blk)       # [*clat, dof(, N)]
    return cplx.cdot_general(cplx.conj(P), ax,
                             (((4,), (4,)), ((0, 1, 2, 3), (0, 1, 2, 3))))


def coarse_matrix(op: BSROperator, P: CArray, block=(2, 2, 2, 2),
                  normal: bool = True) -> CArray:
    """Galerkin A_c = P^H A P as a dense [M, M] split-complex pair
    (M = n_aggregates * K), from ONE batched apply of the level operator to
    all M coarse basis columns (O(V*M) memory)."""
    clat = tuple(P.shape[:4])
    K = P.shape[-1]
    M = volume(clat) * K
    blk = _blk_shape(op)
    eye = torch.eye(M, dtype=P.dtype, device=P.device).reshape(clat + (K, M))
    cols = _prolong(P, CArray(eye, torch.zeros_like(eye)), block, sc=blk)  # [*lat,*blk,M]
    acols = _level_apply(op, cols, normal)
    r = _restrict(P, acols, block, n_blk=len(blk))                        # [*clat,K,M]
    return cplx.cmap(lambda a: a.reshape(M, M), r)


def _real_embedding(A_c: CArray) -> torch.Tensor:
    """[[re, -im], [im, re]]: the real 2M x 2M form of a complex matrix."""
    return torch.cat([torch.cat([A_c.re, -A_c.im], 1),
                      torch.cat([A_c.im, A_c.re], 1)], 0)


def _coarse_solve(solve: Callable, P: CArray, rc: CArray) -> CArray:
    """The dense coarse solve of restricted [*clat, K(, tail)] fields
    through ``solve`` on the real embedding, all columns in one call."""
    M = volume(P.shape[:4]) * P.shape[-1]
    rhs = torch.cat([rc.re.reshape(M, -1), rc.im.reshape(M, -1)], 0)
    sol = solve(rhs)
    return CArray(sol[:M].reshape(rc.shape), sol[M:].reshape(rc.shape))


def two_grid_preconditioner(op: BSROperator, P: CArray, A_c: CArray,
                            block=(2, 2, 2, 2), omega: float = 0.0,
                            normal: bool = True) -> Callable:
    """M r ~ A^{-1} r: the coarse correction P A_c^{-1} P^H r through a
    Cholesky factor of A_c's real embedding (A_c Hermitian PD, so the
    embedding is SPD), made once, plus an optional post-smoothing
    Richardson step of weight ``omega``."""
    L = torch.linalg.cholesky(_real_embedding(A_c))
    blk = _blk_shape(op)
    # the level's own operator: coarse Galerkin operators are Hermitian PD
    # and are smoothed directly, not through A_c^H A_c
    A = _level_fn(op, normal) if omega else None

    def prec(r):
        rc = _restrict(P, r, block, n_blk=len(blk))
        c = _coarse_solve(lambda b: torch.cholesky_solve(b, L), P, rc)
        x = _prolong(P, c, block, sc=blk)
        if omega:
            ax = A(x)
            x = CArray(x.re + omega * (r.re - ax.re), x.im + omega * (r.im - ax.im))
        return x

    return prec


def chebyshev_smoother(A: Callable, lam_max: float, degree: int = 4,
                       theta: float = 30.0) -> Callable:
    """Degree-``degree`` Chebyshev smoother x = p(A) r targeting the band
    [lam_max/theta, lam_max] (the standard d-term recurrence, Saad Alg.
    12.1 seeding: the first direction is r/theta itself)."""
    lo, hi = lam_max / theta, lam_max
    th = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = th / delta

    def smooth(r):
        rho = 1.0 / sigma
        x = CArray(r.re / th, r.im / th)
        d = x
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            ax = A(x)
            res = CArray(r.re - ax.re, r.im - ax.im)
            d = CArray((rho * rho_new) * d.re + (2.0 * rho_new / delta) * res.re,
                       (rho * rho_new) * d.im + (2.0 * rho_new / delta) * res.im)
            x = CArray(x.re + d.re, x.im + d.im)
            rho = rho_new
        return x

    return smooth


def symmetric_two_grid_preconditioner(op: BSROperator, P: CArray, A_c: CArray,
                                      block=(2, 2, 2, 2),
                                      omega: Optional[float] = None,
                                      normal: bool = True,
                                      cheby_degree: Optional[int] = None,
                                      cheby_theta: float = 30.0) -> Callable:
    """Symmetrised V(1,1) two-grid cycle, an SPD preconditioner for pcg:

        x1 = S r;  x2 = x1 + P A_c^{-1} P^H (r - A x1)
        M r = x2 + S (r - A x2)

    S is one Richardson step (weight ``omega``, by default 0.8 /
    lambda_max(A) from 30 power iterations) or, with ``cheby_degree``, a
    :func:`chebyshev_smoother` on [lambda_max/cheby_theta, lambda_max]."""
    A = _level_fn(op, normal)
    lam = None
    if omega is None or cheby_degree is not None:
        probe = _randn(op, np.random.default_rng(0), tuple(op.dim_d) + _blk_shape(op))
        lam, _ = power_iteration(A, probe, iters=30)
        lam = float(lam)
        if omega is None:
            omega = 0.8 / lam

    if cheby_degree is not None:
        S = chebyshev_smoother(A, lam * 1.05, degree=cheby_degree, theta=cheby_theta)
    else:
        def S(r):
            return CArray(omega * r.re, omega * r.im)

    coarse = two_grid_preconditioner(op, P, A_c, block, omega=0.0, normal=normal)

    def prec(r):
        x1 = S(r)
        ax1 = A(x1)
        c = coarse(CArray(r.re - ax1.re, r.im - ax1.im))
        x2 = CArray(x1.re + c.re, x1.im + c.im)
        ax2 = A(x2)
        s2 = S(CArray(r.re - ax2.re, r.im - ax2.im))
        return CArray(x2.re + s2.re, x2.im + s2.im)

    return prec


def two_grid_error_contraction(op: BSROperator, P, A_c, block=(2, 2, 2, 2),
                               omega: float = 0.0, key: int = 0,
                               normal: bool = True) -> float:
    """||(I - M A) e|| / ||e|| on a random error vector: the two-grid
    convergence factor (< 1: the cycle contracts)."""
    e = _randn(op, np.random.default_rng(key), tuple(op.dim_d) + _blk_shape(op))
    prec = two_grid_preconditioner(op, P, A_c, block, omega, normal=normal)
    corr = prec(_level_apply(op, e, normal))
    e_new = CArray(e.re - corr.re, e.im - corr.im)
    return float(torch.sqrt(_inner(e_new, e_new) / _inner(e, e)))


def build_prolongator_chiral(op: BSROperator, block=(2, 2, 2, 2), K: int = 4,
                             setup_iters: int = 8, key=0) -> CArray:
    """Chiral-doubled near-null prolongator for multigrid on the unsquared
    D: K random vectors smoothed toward the near-kernel of D^H D, each
    split into its two chiralities (gamma5 is diagonal (+1, +1, -1, -1) in
    the DeGrand-Rossi basis, so the split zeroes spin halves) before
    aggregation.  A_c = P^H D P then inherits gamma5-Hermiticity.  Returns
    CArray [*clat, dof, 2K] with block-orthonormal columns."""
    blk = _blk_shape(op)
    if len(blk) != 2 or blk[0] != 4:
        raise ValueError("chiral doubling needs a 4-spinor operator")
    v = _randn(op, np.random.default_rng(key), tuple(op.dim_d) + blk + (K,))
    v = _smooth_near_null(_level_fn(op, True), v, setup_iters)

    # [..., 4, 3, K] -> [..., 4, 3, 2K]: upper (spins 0:2) and lower (2:4)
    # halves in separate columns
    def double(a):
        up, dn = a.clone(), a.clone()
        up[..., 2:, :, :] = 0.0
        dn[..., :2, :, :] = 0.0
        return torch.cat([up, dn], dim=-1)

    return _block_cholqr(_aggregate(cplx.cmap(double, v), block, n_blk=len(blk)))


def mg_preconditioner_d(op: BSROperator, P: CArray, A_c: Optional[CArray] = None,
                        block=(2, 2, 2, 2), smooth_steps: int = 4) -> Callable:
    """Multigrid cycle on the unsquared D, the flexible right
    preconditioner of :func:`solvers.fgcr`:

        x1 = S r;   x2 = x1 + P A_c^{-1} P^H (r - D x1)
        M r = x2 + S (r - D x2)

    S is ``smooth_steps`` unrestarted GCR steps on D.  A_c = P^H D P (not
    Hermitian) is solved exactly through an LU of its real embedding, made
    once.  Per application: 2 * smooth_steps + 2 fine D-applies and one
    coarse triangular solve; a trailing column axis rides every stage.
    ``A_c`` reuses a :func:`coarse_matrix` result (normal=False); built
    here otherwise."""
    if A_c is None:
        A_c = coarse_matrix(op, P, block, normal=False)
    LU, piv = torch.linalg.lu_factor(_real_embedding(A_c))
    blk = _blk_shape(op)
    n_blk = len(blk)
    D = _level_fn(op, False)

    def prec(r):
        has_cols = r.re.ndim == 4 + n_blk + 1

        def S(t):
            return fgcr(D, t, tol=0.0, maxiter=smooth_steps, restart=smooth_steps,
                        cols=has_cols)[0]

        x1 = S(r)
        dx1 = D(x1)
        rc = _restrict(P, CArray(r.re - dx1.re, r.im - dx1.im), block, n_blk=n_blk)
        c = _coarse_solve(lambda b: torch.linalg.lu_solve(LU, piv, b), P, rc)
        pc = _prolong(P, c, block, sc=blk)
        x2 = CArray(x1.re + pc.re, x1.im + pc.im)
        dx2 = D(x2)
        s2 = S(CArray(r.re - dx2.re, r.im - dx2.im))
        return CArray(x2.re + s2.re, x2.im + s2.im)

    return prec


def coarse_bsr_operator(op: BSROperator, P: CArray, block=(2, 2, 2, 2),
                        normal: bool = True,
                        A_c: Optional[CArray] = None) -> BSROperator:
    """The Galerkin coarse operator as a coarse-lattice AoS BSR stencil with
    K x K blocks over the {0, +-1}^4 displacements (D^H D reaches two fine
    hops, whose bent paths couple corner aggregates), read off the dense
    A_c on the host, with a check that nothing outside the stencil was
    dropped.  Built on A_c's device in its precision."""
    if A_c is None:
        A_c = coarse_matrix(op, P, block, normal)
    clat = tuple(P.shape[:4])
    K = P.shape[-1]
    part_dt = A_c.re.cpu().numpy().dtype
    ac = A_c.re.cpu().double().numpy() + 1j * A_c.im.cpu().double().numpy()
    ac = ac.reshape(clat + (K,) + clat + (K,))

    choices = []
    for mu in range(4):
        if clat[mu] == 1:
            choices.append((0,))
        elif clat[mu] == 2:
            choices.append((0, 1))     # +1 and -1 are the same neighbour
        else:
            choices.append((0, 1, -1))
    offsets = list(itertools.product(*choices))
    blocks = np.zeros(clat + (len(offsets), K, K), dtype=complex)
    for k, off in enumerate(offsets):
        for c1 in np.ndindex(*clat):
            c2 = tuple((a + o) % d for a, o, d in zip(c1, off, clat))
            blocks[c1 + (k,)] = ac[c1 + (slice(None),) + c2]

    # nothing outside the stencil was dropped
    if not np.isclose(float(np.abs(ac).sum()), float(np.abs(blocks).sum()), rtol=1e-8):
        raise ValueError(
            "Galerkin coarse operator is not nearest-neighbor on the "
            "coarse lattice (aggregate width < stencil reach?)")
    return bsr_from_stencil(
        "xyztc", "xyztC", clat, {"c": K}, {"C": K}, offsets,
        CArray(blocks.real.astype(part_dt), blocks.imag.astype(part_dt)),
        layout="aos", device=A_c.device)


def build_hierarchy(op: BSROperator, levels: int = 2, block=(2, 2, 2, 2),
                    K: int = 4, setup_iters: int = 8, key=0):
    """Recursive multilevel setup: a list of (op_l, P_l, A_c_l, block_l,
    normal_l) for l = 0..levels-1, where op_{l+1} =
    coarse_bsr_operator(op_l, P_l).  Level 0 targets the normal operator
    D^H D; the coarse Galerkin operators are Hermitian PD and deeper
    levels target them directly.  Each level's dense A_c is computed once
    and shared with the coarse-operator extraction."""
    out = []
    cur = op
    for lv in range(levels):
        normal = lv == 0
        blk = tuple(min(b, d) for b, d in zip(block, cur.dim_d))
        kk = min(K, volume(_blk_shape(cur)))
        P = build_prolongator(cur, block=blk, K=kk, setup_iters=setup_iters,
                              key=key + lv, normal=normal)
        A_c = coarse_matrix(cur, P, blk, normal=normal)
        out.append((cur, P, A_c, blk, normal))
        if lv + 1 < levels:
            cur = coarse_bsr_operator(cur, P, blk, normal=normal, A_c=A_c)
    return out


def vcycle_preconditioner(hierarchy, omegas=None, cheby_degree: Optional[int] = None,
                          cheby_theta: float = 30.0) -> Callable:
    """Recursive V-cycle over a :func:`build_hierarchy` result: at each
    level a coarse correction (recursing down to the dense bottom solve)
    and a post-smooth, one Richardson step by default or a degree-d
    :func:`chebyshev_smoother` per level with ``cheby_degree``."""
    applies = [_level_fn(op_l, normal_l) for (op_l, _, _, _, normal_l) in hierarchy]
    # spectral estimates only where something below needs them
    lams = None
    if omegas is None or cheby_degree is not None:
        lams = []
        rng = np.random.default_rng(0)
        for (op_l, _, _, _, _), A_l in zip(hierarchy, applies):
            x0 = _randn(op_l, rng, tuple(op_l.dim_d) + _blk_shape(op_l))
            lam, _ = power_iteration(A_l, x0, iters=15)
            lams.append(float(lam))
    if omegas is None:
        omegas = [0.8 / v for v in lams]

    def make(level):
        op_l, P_l, A_c_l, blk_l, normal_l = hierarchy[level]
        A_l = applies[level]
        if level + 1 >= len(hierarchy):
            # bottom: the dense coarse solve; the requested smoother
            # applies here too
            if cheby_degree is None:
                return two_grid_preconditioner(op_l, P_l, A_c_l, blk_l,
                                               omega=omegas[level], normal=normal_l)
            base = two_grid_preconditioner(op_l, P_l, A_c_l, blk_l, omega=0.0,
                                           normal=normal_l)
            S_b = chebyshev_smoother(A_l, lams[level] * 1.05, degree=cheby_degree,
                                     theta=cheby_theta)

            def prec_bottom(r):
                x = base(r)
                ax = A_l(x)
                s = S_b(CArray(r.re - ax.re, r.im - ax.im))
                return CArray(x.re + s.re, x.im + s.im)
            return prec_bottom

        # the next level's cycle replaces the dense coarse solve
        inner = make(level + 1)
        blk = _blk_shape(op_l)
        if cheby_degree is not None:
            S = chebyshev_smoother(A_l, lams[level] * 1.05, degree=cheby_degree,
                                   theta=cheby_theta)
        else:
            w = omegas[level]

            def S(r):
                return CArray(w * r.re, w * r.im)

        def prec(r):
            # the coarse fields [*clat, K(, N)] are the next level's canonical
            # fields: its operator is applied directly there
            c = inner(_restrict(P_l, r, blk_l, n_blk=len(blk)))
            x = _prolong(P_l, c, blk_l, sc=blk)
            ax = A_l(x)
            s = S(CArray(r.re - ax.re, r.im - ax.im))
            return CArray(x.re + s.re, x.im + s.im)
        return prec

    return make(0)


# ---------------------------------------------------------------------------
# Two-level multigrid of the SoA Wilson-clover operator (no JAX counterpart)
# ---------------------------------------------------------------------------


def _chiral_blocks(parts: Sequence[torch.Tensor], block) -> torch.Tensor:
    """SoA field parts [n_i, 12, *lat] as aggregate blocks [*clat, 2, D,
    sum n_i]: each coarse site's two chiralities apart (spins 0-1 and 2-3,
    g5 = diag(1, 1, -1, -1) in the DeGrand-Rossi basis), D = 2 spins x 3
    colours x the aggregate's sites, the parts' columns side by side (one
    copy a part)."""
    lat = tuple(parts[0].shape[2:])
    c = tuple(d // b for d, b in zip(lat, block))
    perm = (3, 5, 7, 9, 1, 2, 4, 6, 8, 10, 0)
    cols = [a.shape[0] for a in parts]
    out = parts[0].new_empty(c + (2, 6) + tuple(block) + (sum(cols),))
    at = 0
    for a, n in zip(parts, cols):
        split = (n, 2, 6) + tuple(v for cb in zip(c, block) for v in cb)
        out[..., at:at + n].copy_(a.reshape(split).permute(perm))
        at += n
    return out.reshape(c + (2, 6 * volume(block), sum(cols)))


def _chiral_fields(v: torch.Tensor, block) -> torch.Tensor:
    """The inverse of :func:`_chiral_blocks` for one part: [*clat, 2, D, n]
    -> [n, 12, *lat]."""
    c, n = tuple(v.shape[:4]), v.shape[-1]
    v = v.reshape(c + (2, 6) + tuple(block) + (n,)).permute(10, 4, 5, 0, 6, 1, 7, 2, 8, 3, 9)
    return v.reshape((n, 12) + tuple(ci * b for ci, b in zip(c, block)))


def _restrict_chiral(P: CArray, x: CArray, block) -> CArray:
    """P^H x: SoA fine fields [n, 12, *lat] -> coarse [*clat, 2K, n]
    (chirality-major), one product a part of P over both parts of x."""
    n = x.re.shape[0]
    xb = _chiral_blocks([x.re, x.im], block)
    with cplx._full_f32():
        a = torch.matmul(P.re.transpose(-1, -2), xb)      # [*clat, 2, K, 2n]
        b = torch.matmul(P.im.transpose(-1, -2), xb)
    shape = tuple(P.shape[:4]) + (2 * P.shape[-1], n)
    return CArray((a[..., :n] + b[..., n:]).reshape(shape),
                  (a[..., n:] - b[..., :n]).reshape(shape))


def _prolong_chiral(P: CArray, c: CArray, block) -> CArray:
    """P c: coarse [*clat, 2K, n] -> SoA fine fields [n, 12, *lat]."""
    clat, K, n = tuple(P.shape[:4]), P.shape[-1], c.re.shape[-1]
    cc = torch.cat([c.re, c.im], -1).reshape(clat + (2, K, 2 * n))
    with cplx._full_f32():
        a = torch.matmul(P.re, cc)                        # [*clat, 2, D, 2n]
        b = torch.matmul(P.im, cc)
    return CArray(_chiral_fields(a[..., :n] - b[..., n:], block),
                  _chiral_fields(a[..., n:] + b[..., :n], block))


def _coarse_offsets(clat: Sequence[int]) -> list:
    """The coarse site itself and its nearest neighbours, one offset each
    (on an extent of 2 the two neighbours are one site; on 1, none)."""
    offs = [(0, 0, 0, 0)]
    for mu in range(4):
        for s in (1, -1):
            if clat[mu] > 2 or (clat[mu] == 2 and s == 1):
                d = [0, 0, 0, 0]
                d[mu] = s
                offs.append(tuple(d))
    return offs


def _colouring(clat: Sequence[int], offsets) -> Tuple[int, np.ndarray]:
    """A distance-2 colouring of the coarse torus: (number of colours,
    the colour of each site in row-major order).  No site has two
    neighbours (``offsets``, itself included) of one colour, so a probe
    summed over one colour's aggregates meets each coarse site through
    one offset at most.  Linear, sum_mu w_mu c_mu mod m, where one exists
    with m <= 32 (16 colours at 8^3x16); else c_mu mod k_mu in each
    direction (k_mu the extent up to 4, or its least divisor from 3)."""
    lat = np.array(clat)
    diffs = {tuple((np.array(a) - np.array(b)) % lat) for a in offsets for b in offsets}
    diffs = np.array(sorted(diffs - {(0, 0, 0, 0)}), dtype=np.int64).reshape(-1, 4)
    coords = np.indices(tuple(clat)).reshape(4, -1).T
    for m in range(len(offsets), 33):
        steps = [m // math.gcd(m, int(L)) for L in clat]   # w L = 0 mod m
        for w in itertools.product(*[range(0, m, s) for s in steps]):
            if np.all((diffs @ np.array(w)) % m):
                return m, (coords @ np.array(w)) % m
    k = [L if L <= 4 else next(d for d in range(3, L + 1) if L % d == 0) for L in clat]
    return int(np.prod(k)), np.ravel_multi_index(tuple((coords % k).T), k)


#: coarse columns a probe of :func:`galerkin_coarse_operator` takes at once
#: (its fine fields hold that many columns of the lattice: memory, not the
#: result)
PROBE_COLUMNS = 8


def galerkin_coarse_operator(op: CloverOperator, P: CArray, block) -> BSROperator:
    """The Galerkin operator P^H D P of an SoA clover operator as a coarse
    BSR operator in mode "gather" (blocks [V_c, 2K, nnz*2K] in the batched
    product's layout, ``jj_flat`` the neighbours' flat sites), built on
    P's device with no dense coarse matrix: for each colour of
    :func:`_colouring`, ``PROBE_COLUMNS`` coarse columns at a time, the prolonged
    probe (the columns of P summed over that colour's aggregates) goes
    through ``apply_clover`` once and is restricted; each coarse site
    reads the block of the one offset that reaches that colour."""
    clat, K = tuple(P.shape[:4]), P.shape[-1]
    nc, V = 2 * K, volume(clat)
    dev, dt = P.re.device, P.re.dtype
    offs = _coarse_offsets(clat)
    nnz = len(offs)
    m, col = _colouring(clat, offs)
    colour = torch.as_tensor(col, device=dev).reshape(clat)
    site = torch.arange(V, device=dev).reshape(clat)

    def at_offsets(t):                                    # [V, nnz]: t(c + offset)
        return torch.stack([torch.roll(t, tuple(-o for o in off), (0, 1, 2, 3)).reshape(-1)
                            for off in offs], 1)

    near, jj = at_offsets(colour), at_offsets(site)
    bre = torch.zeros((V, nc, nnz, nc), dtype=dt, device=dev)
    bim = torch.zeros_like(bre)
    for k in range(m):
        hit = near == k
        rows = hit.any(1).nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        o = hit[rows].to(torch.uint8).argmax(1)
        mask = (colour == k).to(dt)
        for j0 in range(0, nc, PROBE_COLUMNS):
            nj = min(PROBE_COLUMNS, nc - j0)
            j = torch.arange(nj, device=dev)
            e = torch.zeros(clat + (nc, nj), dtype=dt, device=dev)
            e[..., j0 + j, j] = mask[..., None].expand(clat + (nj,))
            y = apply_clover(op, _prolong_chiral(P, CArray(e, torch.zeros_like(e)), block))
            r = _restrict_chiral(P, y, block)
            bre[rows, :, o, j0:j0 + nj] = r.re.reshape(V, nc, nj)[rows]
            bim[rows, :, o, j0:j0 + nj] = r.im.reshape(V, nc, nj)[rows]
            del e, y, r

    def lay(a):                                           # a view as [*clat, nnz, 2K, 2K]
        return a.permute(0, 2, 1, 3).reshape(clat + (nnz, nc, nc))

    return BSROperator(CArray(lay(bre), lay(bim)), None, (), clat, bi=(nc,), bd=(nc,),
                       oim="xyztc", odm="xyztC", mode="gather", blk_i="c", blk_d="C",
                       jj_flat=jj,
                       row_counts=torch.full((V,), nnz, dtype=torch.int32, device=dev))


def _orthonormalise(v: CArray) -> CArray:
    """The columns of fields [n, ...] made orthonormal: their n x n Gram
    matrix (f32 products, Cholesky in complex128), v <- L^-1 v."""
    n = v.re.shape[0]
    vr, vi = v.re.reshape(n, -1), v.im.reshape(n, -1)
    with cplx._full_f32():
        g = torch.complex((vr @ vr.T + vi @ vi.T).double(), (vi @ vr.T - vr @ vi.T).double())
    g = g + 1e-12 * torch.trace(g).real / n * torch.eye(n, dtype=g.dtype, device=g.device)
    li = torch.linalg.inv(torch.linalg.cholesky(g)).to(torch.complex64 if vr.dtype ==
                                                       torch.float32 else torch.complex128)
    lr, lm = li.real.contiguous(), li.imag.contiguous()
    with cplx._full_f32():
        out = CArray(lr @ vr - lm @ vi, lr @ vi + lm @ vr)
    return cplx.cmap(lambda a: a.reshape(v.re.shape), out)


def _each_column(v: CArray, fn: Callable) -> CArray:
    """``fn`` on each column [1, 12, *lat] of fields [n, 12, *lat]."""
    out = cplx.cmap(torch.empty_like, v)
    for i in range(v.re.shape[0]):
        y = fn(cplx.cmap(lambda a: a[i:i + 1], v))
        out.re[i:i + 1].copy_(y.re)
        out.im[i:i + 1].copy_(y.im)
    return out


@dataclass(frozen=True)
class CloverMG:
    """A two-level multigrid of an SoA clover operator ``op``: the
    prolongator ``P`` [*clat, 2, D, K] (the test vectors' two chiralities
    apart, block-orthonormal on each aggregate of extent ``block``), the
    Galerkin coarse operator ``coarse`` (N_c = 2K, mode "gather"), and
    the cycle's step counts: ``smooth_steps`` GCR steps on D a smoothing,
    ``coarse_steps`` GCR steps on the coarse operator a coarse solve."""

    op: CloverOperator
    P: CArray
    coarse: BSROperator
    block: Tuple[int, ...]
    smooth_steps: int = 4
    coarse_steps: int = 6


def _mg_from_vectors(op: CloverOperator, v: CArray, block, **cycle) -> CloverMG:
    """P from the test vectors (chirally split, CholeskyQR2 on each
    aggregate) and its Galerkin coarse operator."""
    P = _block_cholqr(CArray(_chiral_blocks([v.re], block), _chiral_blocks([v.im], block)))
    return CloverMG(op, P, galerkin_coarse_operator(op, P, block), tuple(block), **cycle)


def clover_mg_setup(op: CloverOperator, block=(4, 4, 4, 4), nvec: int = 20, key: int = 0,
                    setup_rounds: int = 3, setup_steps: int = 8, refine_rounds: int = 1,
                    smooth_steps: int = 4, coarse_steps: int = 6) -> CloverMG:
    """Set up the two-level multigrid of an SoA clover operator.

    ``nvec`` Gaussian test vectors from a generator seeded with ``key`` on
    the operator's device are made near-null by inverse iterations:
    ``setup_rounds`` times, each vector through ``setup_steps`` GCR steps
    on D (an approximate D^-1 v), then the set orthonormalised; the
    hierarchy is built from them; ``refine_rounds`` times more, each
    vector through the built cycle (the multigrid's own D^-1 v) and the
    hierarchy built again.  Every apply is ``apply_clover`` on one
    column, but the coarse operator's probes (``PROBE_COLUMNS``)."""
    if op.hop.mode != "stencil_soa":
        raise ValueError("clover_mg_setup needs an operator built with layout='soa'")
    lat, dev = tuple(op.hop.dim_i), op.hop.blocks_re.device
    if any(d % b for d, b in zip(lat, block)):
        raise ValueError(f"aggregates {tuple(block)} do not tile the lattice {lat}")
    dt = torch.promote_types(op.hop.blocks_re.dtype, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))
    v = CArray(*(torch.randn((nvec, 12) + lat, generator=gen, device=dev, dtype=dt)
                 for _ in range(2)))
    cycle = dict(smooth_steps=smooth_steps, coarse_steps=coarse_steps)
    D = functools.partial(apply_clover, op)
    for _ in range(setup_rounds):
        v = _orthonormalise(_each_column(v, lambda t: fgcr(
            D, t, tol=0.0, maxiter=setup_steps, restart=setup_steps, counter=None)[0]))
    mg = _mg_from_vectors(op, v, block, **cycle)
    for _ in range(refine_rounds):
        v = _orthonormalise(_each_column(v, functools.partial(mg_cycle, mg)))
        del mg
        mg = _mg_from_vectors(op, v, block, **cycle)
    return mg


@tracker.spanned("mg.coarse")
def _coarse_solve_gcr(mg: CloverMG, rc: CArray) -> CArray:
    """The coarse correction's solve: ``coarse_steps`` GCR steps on the
    coarse operator's apply (``apply_coarse``), counted as
    ``mg.coarse_iterations``.  A fixed count, as the smoother's: a
    convergence read would stop the device while the host launches the
    small coarse vectors' passes (the host holds the pace there)."""
    return fgcr(functools.partial(apply_coarse, mg.coarse), rc, tol=0.0,
                maxiter=mg.coarse_steps, restart=mg.coarse_steps,
                counter="mg.coarse_iterations")[0]


@tracker.spanned("mg.cycle")
def mg_cycle(mg: CloverMG, r: CArray) -> CArray:
    """One application of the multigrid cycle to SoA fields r [n, 12, *lat]
    (the right preconditioner of FGCR on D, ``mg_preconditioner_d``'s
    scheme):

        x1 = S r;   x2 = x1 + P A_c^-1 P^H (r - D x1);   M r = x2 + S (r - D x2)

    S is ``smooth_steps`` GCR steps on D, A_c^-1 the coarse GCR; 2
    ``smooth_steps`` + 2 fine applies.  Counted as ``mg.cycles``."""
    tracker.count("mg.cycles")
    D = functools.partial(apply_clover, mg.op)

    def S(t):
        return fgcr(D, t, tol=0.0, maxiter=mg.smooth_steps, restart=mg.smooth_steps,
                    counter=None)[0]

    x1 = S(r)
    dx1 = D(x1)
    rc = _restrict_chiral(mg.P, CArray(r.re - dx1.re, r.im - dx1.im), mg.block)
    pc = _prolong_chiral(mg.P, _coarse_solve_gcr(mg, rc), mg.block)
    x2 = CArray(x1.re + pc.re, x1.im + pc.im)
    dx2 = D(x2)
    s2 = S(CArray(r.re - dx2.re, r.im - dx2.im))
    return CArray(x2.re + s2.re, x2.im + s2.im)


def mg_solve_clover(mg: CloverMG, b: CArray, tol: float = 1e-5, maxiter: int = 1000,
                    restart: int = 8):
    """Solve D x = b (SoA fields [n, 12, *lat]) by ``solvers.fgcr`` on D,
    right-preconditioned by :func:`mg_cycle`, to ``tol`` on |D x - b| /
    |b|, the convergence read after every iteration.  Returns (x, |r|^2,
    iterations) as the other solves do; an iteration is one cycle and one
    apply of D, and only these iterations count as ``solver.iterations``."""
    return fgcr(functools.partial(apply_clover, mg.op), b, M=functools.partial(mg_cycle, mg),
                tol=tol, maxiter=maxiter, restart=restart, read_each=True)
