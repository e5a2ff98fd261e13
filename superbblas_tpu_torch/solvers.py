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
the iterations it ran to the ``solver.iterations`` counter, and ``cg``
those it ran on the fused kernels also to ``solver.fused_iterations``.

``cg`` on one system of split-complex f32 fields on a CUDA device
(contiguous planes, or DTensors of such shards) runs an iteration's
vector updates and inner products as the three kernels of
``ops/cg_update.py`` (22 planes of field traffic where the PyTorch ops
move 78); every other operand takes the PyTorch ops.

With ``cols=True`` the LAST axis of the operands holds independent
right-hand sides: the inner products keep it, and the step sizes become
per-column vectors that broadcast against it.

On sharded ``DTensor`` operands the PyTorch ops propagate shard-locally,
and each inner product is a partial sum plus one all-reduce
(``cplx.reduced``), so the host reads of the convergence test see the
global values.  ``cg``'s fused loop does the same by hand: its kernels
run on the local shards, each partial sum goes through ``cplx.reduced``,
and the results are wrapped back with the operands' mesh and placements.
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
    if _fusable(b, x0, cols):
        return _cg_fused(A, b, x0, tol, maxiter, callback)
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


def _fusable(b, x0, cols: bool) -> bool:
    """Whether ``cg`` runs its iteration on ``ops/cg_update.py``'s kernels:
    one system (not ``cols``) of split-complex f32 fields whose planes
    (local shards) are contiguous, of one shape, on a CUDA device."""
    from .parallel._local import local

    if cols or not cplx.is_carray(b) or not (x0 is None or cplx.is_carray(x0)):
        return False
    planes = [*local(b)] + ([] if x0 is None else [*local(x0)])
    return all(t.device.type == "cuda" and t.dtype == torch.float32 and t.is_contiguous()
               and t.shape == planes[0].shape for t in planes)


def _all_reduced(t, like):
    """The 0-dim partial sum ``t`` of this rank's shards of fields placed
    as the DTensor ``like``, summed over the mesh axes that shard them
    (``cplx.reduced``), as a local tensor; ``t`` itself where ``like`` is
    None."""
    if like is None:
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pl = [Partial() if isinstance(p, Shard) else Replicate() for p in like.placements]
    return cplx.reduced(DTensor.from_local(t, like.device_mesh, pl, run_check=False)).to_local()


def _global(c, like):
    """A local field (CArray) or 0-dim scalar as ``like``'s DTensors: the
    field placed as ``like``, the scalar replicated; itself where ``like``
    is None."""
    if like is None:
        return c
    if cplx.is_carray(c):
        from .parallel._local import from_local

        return from_local(c, like)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(c, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _cg_fused(A, b, x0, tol, maxiter, callback):
    """``cg``'s loop where ``_fusable``: an iteration is A p, then
    ``cg_dot``, ``cg_xr`` and ``cg_p`` on the fields' local planes, each
    partial sum of shards all-reduced once; the scalars stay 0-dim tensors
    on the device, and ``cg_p`` gives the ratio the convergence read
    takes.  ``b`` and ``x0`` are never written: r and p start as ``b``
    (or r as b - A x0), the first iteration writes new fields, and the
    later ones update cg's own in place."""
    from .ops import cg_update as U
    from .parallel._local import dtensor_of, local

    like = dtensor_of(b)
    bl = local(b)
    ws = U.workspace(bl.re)
    if x0 is None:
        x, r = _zeros(bl), bl
        rs = _all_reduced(U.cg_dot(r, r, ws), like)
        bs = torch.clamp_min(rs, 1e-30)
    else:
        x = local(x0)
        r = cplx.cmap(torch.Tensor.contiguous, local(_axpy_c((-1.0, 0.0), A(x0), b)))
        rs = _all_reduced(U.cg_dot(r, r, ws), like)
        bs = torch.clamp_min(_all_reduced(U.cg_dot(bl, bl, ws), like), 1e-30)
    p, p_arg = r, (b if x0 is None else _global(r, like))
    ratio = rs / bs
    k = 0
    while k < maxiter and _above(ratio, tol):
        ap = cplx.cmap(torch.Tensor.contiguous, local(A(p_arg)))
        pap = _all_reduced(U.cg_dot(p, ap, ws), like)
        first = k == 0
        x_out = cplx.cmap(torch.empty_like, x) if first and x0 is not None else x
        r_out = cplx.cmap(torch.empty_like, r) if first else r
        rs_new = _all_reduced(U.cg_xr(x, p, r, ap, rs, pap, x_out, r_out, ws), like)
        p_out = cplx.cmap(torch.empty_like, p) if first else p
        ratio = U.cg_p(r_out, p, rs_new, rs, bs, p_out)
        x, r, rs = x_out, r_out, rs_new
        if first:
            p, p_arg = p_out, _global(p_out, like)
        k += 1
        if callback is not None:
            callback(_global(rs, like))
    tracker.count("solver.iterations", k)
    tracker.count("solver.fused_iterations", k)
    return _global(x, like), _global(rs, like), k


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
         cols: bool = False, counter: Optional[str] = "solver.iterations",
         read_each: bool = False):
    """Flexible restarted GCR(``restart``) for general ``A`` with an
    arbitrary, possibly varying, right preconditioner ``M`` (e.g. a
    multigrid V-cycle).  Each cycle minimises ||b - A x|| over the
    preconditioned Krylov space with the residual-projection recurrence.

    Returns (x, |r|^2, iterations); ``cols=True`` solves independent
    right-hand sides in the trailing axis with per-column projection
    coefficients.  One A and one M apply per iteration; each cycle keeps
    ``restart`` direction pairs (z_k, A z_k) and counts ``restart``
    iterations.  With ``read_each`` the convergence test is read after
    every iteration, so the solve stops at the first that meets it (a
    cycle then counts the iterations it ran).  A ``tol`` of 0 reads
    nothing: the fixed count of a smoother.  The iterations go to the
    tracker's ``counter`` (none where it is None: a solve nested in
    another solve's preconditioner counts apart from it)."""
    if M is None:
        M = lambda r: r  # noqa: E731
    x = _zeros(b) if x0 is None else x0
    r = _axpy_c((-1.0, 0.0), A(x), b) if x0 is not None else b
    rs = _inner_r(r, r, cols)
    bs = torch.clamp_min(_inner_r(b, b, cols), 1e-30)
    k = 0
    go = maxiter > 0 and (tol <= 0 or _above(rs / bs, tol))
    while go:
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
            if read_each:
                k += 1
                rs = _inner_r(r, r, cols)
                go = k < maxiter and (tol <= 0 or _above(rs / bs, tol))
                if not go:
                    break
        if not read_each:
            rs = _inner_r(r, r, cols)
            k += restart
            go = k < maxiter and (tol <= 0 or _above(rs / bs, tol))
    if counter is not None:
        tracker.count(counter, k)
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
