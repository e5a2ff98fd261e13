"""Generic Krylov solvers over arbitrary operator applies (counterpart of
``superbblas_tpu/solvers.py``).

Each solver takes any apply function ``A(x)`` on tensors or split-complex
``CArray``s and runs eagerly, as a Python loop.  The scalars stay tensors
on the operands' device.  Where the JAX package runs a
``lax.while_loop``, the loop condition reads one scalar to the host per
iteration (the convergence test), so the iteration counts are those of
the JAX package; the fixed-count loops (``power_iteration``, ``lanczos``,
``refined_solve``) read nothing in the loop.  Iteration counts are
returned as Python ints.

For the tracker (``utils/tracker.py``): a ``cg`` or ``cgne`` solve is one
``solver.cg`` span; each convergence read is a ``solver.read`` span
(host time) and one ``host_reads``; each loop adds
the iterations it ran to the ``solver.iterations`` counter.

With ``cols=True`` the LAST axis of the operands holds independent
right-hand sides: the inner products keep it, and the step sizes become
per-column vectors that broadcast against it.

The solvers are sharding-oblivious: on sharded ``DTensor`` operands the
axpys propagate shard-locally, and each inner product is a partial sum
plus one all-reduce (``cplx.reduced``), so the host reads of the
convergence test see the global values.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import cplx
from .utils import tracker

__all__ = ["cg", "cgne", "bicgstab", "pcg", "fgcr", "power_iteration",
           "lanczos", "ritz_extremes", "refined_solve"]


def _inner_c(a, b, cols: bool = False):
    """<a, b> (complex) as a (re, im) pair; with ``cols`` the reduction
    keeps the LAST axis (per-column scalars for multi-RHS solves)."""
    if cplx.is_carray(a):
        re = a.re * b.re + a.im * b.im
        im = a.re * b.im - a.im * b.re
    else:
        re, im = a * b, torch.zeros_like(a)
    ax = tuple(range(re.ndim - 1)) if cols else tuple(range(re.ndim))
    return cplx.reduced(torch.sum(re, dim=ax)), cplx.reduced(torch.sum(im, dim=ax))


def _inner_r(a, b, cols: bool = False):
    """Real part of <a, b>; with ``cols`` the reduction keeps the LAST
    axis (independent per-column inner products, (N,) vectors that
    broadcast against the trailing column axis of the fields)."""
    v = a.re * b.re + a.im * b.im if cplx.is_carray(a) else a * b
    return cplx.reduced(torch.sum(v, dim=tuple(range(v.ndim - 1))) if cols
                        else torch.sum(v))


def _axpy_c(alpha: Tuple, x, y):
    """y + alpha x for a (re, im) scalar pair."""
    ar, ai = alpha
    if cplx.is_carray(x):
        return cplx.CArray(y.re + ar * x.re - ai * x.im,
                           y.im + ar * x.im + ai * x.re)
    return y + ar * x


def _scale_c(alpha: Tuple, x):
    ar, ai = alpha
    if cplx.is_carray(x):
        return cplx.CArray(ar * x.re - ai * x.im, ar * x.im + ai * x.re)
    return ar * x


def _cdiv(n: Tuple, d: Tuple):
    nr, ni = n
    dr, di = d
    den = torch.clamp_min(dr * dr + di * di, 1e-30)
    return ((nr * dr + ni * di) / den, (ni * dr - nr * di) / den)


def _zeros(x):
    return cplx.cmap(torch.zeros_like, x) if cplx.is_carray(x) else torch.zeros_like(x)


@tracker.spanned("solver.read", events=False)
def _above(ratio, tol: float) -> bool:
    """Host read of the convergence test: max(ratio) > tol^2."""
    return tracker.to_host(torch.max(ratio)) > tol * tol


@tracker.spanned("solver.cg")
def cg(A: Callable, b, x0=None, tol: float = 1e-8, maxiter: int = 100,
       cols: bool = False, callback: Optional[Callable] = None):
    """Conjugate gradients for Hermitian positive-definite ``A``.

    Returns (x, |r|^2, iterations).  With ``cols=True`` the trailing axis
    of ``b`` holds independent right-hand sides solved simultaneously with
    per-column step sizes (one batched apply serves N solves); |r|^2 is
    then (N,) and the loop runs until every column converges.
    ``callback(rs)``, where given, sees |r|^2 after every iteration (the
    residual history; it reads nothing to the host itself)."""
    x = _zeros(b) if x0 is None else x0
    r = _axpy_c((-1.0, 0.0), A(x), b) if x0 is not None else b
    p = r
    rs = _inner_r(r, r, cols)
    bs = torch.clamp_min(_inner_r(b, b, cols), 1e-30)
    k = 0
    while k < maxiter and _above(rs / bs, tol):
        ap = A(p)
        alpha = rs / torch.clamp_min(_inner_r(p, ap, cols), 1e-30)
        x = _axpy_c((alpha, 0.0 * alpha), p, x)
        r = _axpy_c((-alpha, 0.0 * alpha), ap, r)
        rs_new = _inner_r(r, r, cols)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = _axpy_c((beta, 0.0 * beta), p, r)
        rs = rs_new
        k += 1
        if callback is not None:
            callback(rs)
    tracker.count("solver.iterations", k)
    return x, rs, k


@tracker.spanned("solver.cg")
def cgne(A: Callable, Ah: Callable, b, **kw):
    """CG on the normal equations A^H A x = A^H b for general ``A`` with
    adjoint ``Ah``."""
    # cg's own body, so that the solve with its A^H b is one span
    return cg.__wrapped__(lambda v: Ah(A(v)), Ah(b), **kw)


def bicgstab(A: Callable, b, x0=None, tol: float = 1e-8, maxiter: int = 100):
    """BiCGStab for general (non-Hermitian) ``A``, the standard
    lattice-QCD solver for the unsquared Wilson operator.

    Returns (x, |r|^2, iterations)."""
    x = _zeros(b) if x0 is None else x0
    r = _axpy_c((-1.0, 0.0), A(x), b) if x0 is not None else b
    rhat = r
    p = r
    rho = _inner_c(rhat, r)
    bs = torch.clamp_min(_inner_r(b, b), 1e-30)
    k = 0
    while k < maxiter and _above(_inner_r(r, r) / bs, tol):
        v = A(p)
        alpha = _cdiv(rho, _inner_c(rhat, v))
        s = _axpy_c((-alpha[0], -alpha[1]), v, r)
        t = A(s)
        ts = _inner_c(t, s)
        tt = torch.clamp_min(_inner_r(t, t), 1e-30)
        omega = (ts[0] / tt, ts[1] / tt)
        x = _axpy_c(alpha, p, _axpy_c(omega, s, x))
        r = _axpy_c((-omega[0], -omega[1]), t, s)
        rho_new = _inner_c(rhat, r)
        beta = _cdiv(rho_new, rho)
        beta = _cdiv(beta, _cdiv(omega, alpha))   # (rho'/rho)(alpha/omega)
        pm = _axpy_c((-omega[0], -omega[1]), v, p)
        p = _axpy_c(beta, pm, r)
        rho = rho_new
        k += 1
    tracker.count("solver.iterations", k)
    return x, _inner_r(r, r), k


def fgcr(A: Callable, b, M: Optional[Callable] = None, x0=None,
         tol: float = 1e-8, maxiter: int = 100, restart: int = 8,
         cols: bool = False):
    """Flexible restarted GCR(``restart``) for general ``A`` with an
    arbitrary, possibly varying, right preconditioner ``M`` (e.g. a
    multigrid V-cycle).  Each cycle minimises ||b - A x|| over the
    preconditioned Krylov space with the residual-projection recurrence.

    Returns (x, |r|^2, iterations); ``cols=True`` solves independent
    right-hand sides in the trailing axis with per-column projection
    coefficients.  One A and one M apply per iteration; each cycle keeps
    ``restart`` direction pairs (z_k, A z_k) and counts ``restart``
    iterations."""
    if M is None:
        M = lambda r: r  # noqa: E731
    x = _zeros(b) if x0 is None else x0
    r = _axpy_c((-1.0, 0.0), A(x), b) if x0 is not None else b
    rs = _inner_r(r, r, cols)
    bs = torch.clamp_min(_inner_r(b, b, cols), 1e-30)
    k = 0
    while k < maxiter and _above(rs / bs, tol):
        zs, ws = [], []
        for _ in range(restart):
            z = M(r)
            w = A(z)
            for zi, wi in zip(zs, ws):
                beta = _inner_c(wi, w, cols)
                w = _axpy_c((-beta[0], -beta[1]), wi, w)
                z = _axpy_c((-beta[0], -beta[1]), zi, z)
            nrm = torch.sqrt(torch.clamp_min(_inner_r(w, w, cols), 1e-60))
            w = _scale_c((1.0 / nrm, 0.0 * nrm), w)
            z = _scale_c((1.0 / nrm, 0.0 * nrm), z)
            zs.append(z)
            ws.append(w)
            alpha = _inner_c(w, r, cols)
            x = _axpy_c(alpha, z, x)
            r = _axpy_c((-alpha[0], -alpha[1]), w, r)
        rs = _inner_r(r, r, cols)
        k += restart
    tracker.count("solver.iterations", k)
    return x, rs, k


def _real_zero(x):
    """A 0-dim zero of ``x``'s real dtype on its device."""
    t = x.re if cplx.is_carray(x) else x
    dt = t.real.dtype if t.is_complex() else t.dtype
    return torch.zeros((), dtype=dt, device=t.device)


def power_iteration(A: Callable, x0, iters: int = 50):
    """Dominant eigenvalue estimate of Hermitian ``A`` by normalised power
    iteration; returns (lambda_max, x).  One apply per iteration: the
    Rayleigh quotient <x, Ax> comes from the apply that advances x."""
    y, lam = x0, _real_zero(x0)
    for _ in range(iters):
        xn = torch.sqrt(torch.clamp_min(_inner_r(y, y), 1e-30))
        xk = _scale_c((1.0 / xn, 0.0 * xn), y)
        y = A(xk)
        lam = _inner_r(xk, y)          # <x, Ax> with |x| = 1
    xn = torch.sqrt(torch.clamp_min(_inner_r(y, y), 1e-30))
    return lam, _scale_c((1.0 / xn, 0.0 * xn), y)


def lanczos(A: Callable, x0, m: int = 30):
    """m-step Lanczos tridiagonalisation of Hermitian ``A`` from ``x0``.

    Returns (alphas[m], betas[m-1]), the tridiagonal coefficients whose
    eigenvalues are the Ritz values.  No reorthogonalisation.  At a
    breakdown (Krylov space exhausted) the recurrence freezes on the
    device, so trailing alphas and betas stay zero and ``ritz_extremes``
    can trim them."""
    nrm0 = torch.sqrt(torch.clamp_min(_inner_r(x0, x0), 1e-30))
    q = _scale_c((1.0 / nrm0, 0.0 * nrm0), x0)
    q_prev = _zeros(x0)
    zero = _real_zero(x0)
    alphas = zero.new_zeros((m,))
    betas = zero.new_zeros((m,))
    done = torch.zeros((), dtype=torch.bool, device=zero.device)
    for k in range(m):
        w = A(q)
        alpha = _inner_r(q, w)
        w = _axpy_c((-alpha, 0.0 * alpha), q, w)
        beta_prev = betas[k - 1] if k > 0 else zero
        w = _axpy_c((-beta_prev, 0.0 * beta_prev), q_prev, w)
        bsq = _inner_r(w, w)
        beta = torch.sqrt(torch.clamp_min(bsq, 1e-30))
        alphas[k] = torch.where(done, alphas[k], alpha)
        betas[k] = torch.where(done, betas[k], beta)
        done = torch.logical_or(done, bsq < 1e-24)
        q_next = _scale_c((1.0 / beta, 0.0 * beta), w)
        q_next = cplx.CArray(*(torch.where(done, a, b) for a, b in zip(q, q_next))) \
            if cplx.is_carray(q) else torch.where(done, q, q_next)
        q_prev, q = q, q_next
    return alphas, betas[:m - 1]


def ritz_extremes(alphas, betas):
    """(lambda_min, lambda_max) estimates from Lanczos coefficients,
    trimmed at the first breakdown (zero beta) so exhausted Krylov spaces
    add no spurious zero eigenvalues.  Pairs with :func:`lanczos`."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    a = host(alphas)
    b = host(betas)
    nz = np.nonzero(np.abs(b) < 1e-12)[0]
    m = (int(nz[0]) + 1) if nz.size else a.shape[0]
    a, b = a[:m], b[:max(m - 1, 0)]
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    w = np.linalg.eigvalsh(T)
    return float(w[0]), float(w[-1])


def refined_solve(A: Callable, inner_solve: Callable, b, cycles: int = 3):
    """Iterative refinement: ``cycles`` times, ``x += inner_solve(r);
    r = b - A x``, with the residual in the operand precision (outer
    f64/f32 accuracy from an inner bf16/f32 solver).  Returns
    (x, |r|^2)."""
    x = _zeros(b)
    r = b
    for _ in range(cycles):
        dx = inner_solve(r)
        x = _axpy_c((1.0, 0.0), dx, x)
        r = _axpy_c((-1.0, 0.0), A(x), b)
    return x, _inner_r(r, r)


def pcg(A: Callable, M: Callable, b, x0=None, tol: float = 1e-8,
        maxiter: int = 100, cols: bool = False):
    """Preconditioned CG for Hermitian positive-definite ``A`` with an SPD
    preconditioner ``M`` (e.g. a two-grid cycle).  Returns (x, |r|^2,
    iterations); ``cols=True`` as in :func:`cg`."""
    x = _zeros(b) if x0 is None else x0
    r = _axpy_c((-1.0, 0.0), A(x), b) if x0 is not None else b
    z = M(r)
    p = z
    rz = _inner_r(r, z, cols)
    rn = _inner_r(r, r, cols)
    bs = torch.clamp_min(_inner_r(b, b, cols), 1e-30)
    k = 0
    while k < maxiter and _above(rn / bs, tol):
        ap = A(p)
        alpha = rz / torch.clamp_min(_inner_r(p, ap, cols), 1e-30)
        x = _axpy_c((alpha, 0.0 * alpha), p, x)
        r = _axpy_c((-alpha, 0.0 * alpha), ap, r)
        z = M(r)
        rz_new = _inner_r(r, z, cols)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = _axpy_c((beta, 0.0 * beta), p, z)
        rz, rn = rz_new, _inner_r(r, r, cols)
        k += 1
    tracker.count("solver.iterations", k)
    return x, rn, k
