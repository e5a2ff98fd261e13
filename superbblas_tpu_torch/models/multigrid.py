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
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import cplx
from ..bsr import BSROperator, _apply_stencil, apply_stencil_soa, bsr_from_stencil
from ..cplx import CArray
from ..labels import volume
from ..ops.stencil import aos_to_soa, soa_to_aos
from ..solvers import fgcr, power_iteration
from .wilson import _inner, adjoint_operator

__all__ = ["build_prolongator", "coarse_matrix", "coarse_bsr_operator",
           "two_grid_preconditioner", "symmetric_two_grid_preconditioner",
           "two_grid_error_contraction", "chebyshev_smoother",
           "build_hierarchy", "vcycle_preconditioner",
           "build_prolongator_chiral", "mg_preconditioner_d"]


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
    AoS<->SoA conversion at the boundary, so the whole cycle rides it."""
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
