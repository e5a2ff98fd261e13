"""Plain conjugate gradients on the normal equations, for the control:
the reference put in the port's place needs a solver of its own."""

from __future__ import annotations

import torch


def cgne(A, Ah, b: torch.Tensor, tol: float, maxiter: int, dot):
    """x with |A^H (b - A x)| / |A^H b| <= tol by CG's recursive residual,
    or after ``maxiter`` iterations; ``dot(u, v)`` is the real part of
    <u, v> over the whole lattice.  Returns (x, iterations)."""
    rhs = Ah(b)
    x = torch.zeros_like(rhs)
    r, p = rhs, rhs
    rs, bs = dot(r, r), max(dot(rhs, rhs), 1e-300)
    k = 0
    while k < maxiter and rs / bs > tol * tol:
        ap = Ah(A(p))
        alpha = rs / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        k += 1
    return x, k
