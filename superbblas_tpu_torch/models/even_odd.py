"""Even-odd (red-black) preconditioned Wilson solves (counterpart of
``superbblas_tpu/models/even_odd.py``).

With sites checkerboarded into even/odd, the Wilson matrix is

    D = [[ a I   , D_eo ],        a = m + 4 r   (site-diagonal part)
         [ D_oe  , a I  ]]

and solving D psi = b reduces to the half-size Schur system

    Dhat psi_e = b_e - (1/a) D_eo b_o,   Dhat = a - (1/a) D_eo D_oe,

with psi_o = (b_o - D_oe psi_e) / a reconstructed site-locally.

Here the checkerboard is a site mask over the full lattice: the hopping
operator H = D - a I maps even-supported fields to odd-supported ones, so
D_eo z = P_e H z with H applied through the ordinary stencil matvec
(``eo_solve``, ``schur_matvec``, on AoS operators through ``bsr_krylov``).
The Schur CG shared by the solves is ``schur_cg``; the packed
half-lattice solves (no masked waste) are ``models/eo_packed.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import cplx
from ..bsr import BSROperator
from ..cplx import CArray
from ..ops._guard import is_sharded
from .wilson import _axpy, _inner, _zeros_like, adjoint_operator, apply_wilson

__all__ = ["checkerboard_masks", "eo_solve", "schur_matvec", "schur_cg"]


def schur_cg(Dhat, Dhat_h, rhs, n_iters: int):
    """CG on the normal equations Dhat^H Dhat x = Dhat^H rhs, from x = 0,
    for ``n_iters`` iterations; returns (x, |r|^2).  The scalars stay
    0-dim tensors on the operands' device: no host sync in the loop."""
    x = _zeros_like(rhs)
    r = Dhat_h(rhs)
    p = r
    rs = _inner(r, r)
    for _ in range(n_iters):
        ap = Dhat_h(Dhat(p))
        alpha = rs / torch.clamp_min(_inner(p, ap), 1e-30)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, ap, r)
        rs_new = _inner(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = _axpy(beta, p, r)
        rs = rs_new
    return x, rs


def checkerboard_masks(lat_dims: Tuple[int, ...], trailing: int, device="cuda",
                       origin: Optional[Tuple[int, ...]] = None):
    """(even, odd) 0/1 f32 masks shaped [*lat] + [1]*trailing, built with
    numpy and put on ``device``: the card unless the caller names the CPU.
    ``origin``: the global coordinates of the block's first site (a
    shard's offset), whose parity the block's sites add to theirs."""
    coords = np.meshgrid(*[np.arange(d) for d in lat_dims], indexing="ij")
    par = (sum(coords) + sum(origin or ())) % 2
    even = (par == 0).astype(np.float32)
    shape = tuple(lat_dims) + (1,) * trailing
    even = torch.from_numpy(even.reshape(shape)).to(device)
    return even, 1.0 - even


def _mask(m, x):
    """m * x; for a sharded x (DTensors) ``m`` is the mask of x's local
    block (``_masks`` built it) and the product is x's shard."""
    if is_sharded(x):
        from ..parallel._local import from_local, local

        return from_local(_mask(m, local(x)), x)
    if cplx.is_carray(x):
        return CArray(m * x.re, m * x.im)
    return m * x


def _masks(lat_dims, b, nlat: int):
    """The checkerboard masks of ``b``'s sites: of its local block, with
    the parity of the block's global origin, where ``b`` is sharded."""
    if not is_sharded(b):
        return checkerboard_masks(lat_dims, b.ndim - nlat, device=b.device)
    from ..parallel._local import local, shard_origin

    bl = local(b)
    shape = tuple((bl.re if cplx.is_carray(bl) else bl).shape)
    return checkerboard_masks(shape[:nlat], len(shape) - nlat, device=b.device,
                              origin=shard_origin(b)[:nlat])


def _scale(a, x):
    return cplx.scale(a, x)


def schur_matvec(op: BSROperator, a: float, even, odd, v):
    """Dhat v = a v - (1/a) P_e H (H v) for even-supported v (H = D - a I
    maps parities, so the inner product is odd-supported automatically)."""
    hv = _mask(odd, cplx.add(apply_wilson(op, v), _scale(-a, v)))
    hhv = _mask(even, cplx.add(apply_wilson(op, hv), _scale(-a, hv)))
    return cplx.add(_scale(a, v), _scale(-1.0 / a, hhv))


def _schur_matvec_dagger(op_h: BSROperator, a: float, even, odd, v):
    """Dhat^H v from the adjoint operator ``op_h``."""
    def hdag(x):
        return cplx.add(apply_wilson(op_h, x), _scale(-a, x))
    hv = _mask(odd, hdag(v))
    hhv = _mask(even, hdag(hv))
    return cplx.add(_scale(a, v), _scale(-1.0 / a, hhv))


def eo_solve(op: BSROperator, b, a: float, n_iters: int = 50):
    """Solve D psi = b by CG on the normal equations of the even-odd Schur
    complement, for ``n_iters`` iterations; returns (psi, |r_e|^2 of the
    Schur CG).

    ``op`` is the AoS Wilson operator, ``a`` its site-diagonal scalar
    (mass + 4 r), ``b`` [*lat, NS, NC, ncols] (a CArray or a complex
    tensor).  The masks are made on ``b``'s device (for a sharded ``b``,
    those of its local block, from its global origin); the adjoint is
    built once a call and kept by no one."""
    nlat = len(op.dim_d)
    even, odd = _masks(op.dim_i, b, nlat)
    op_h = adjoint_operator(op)

    b_e = _mask(even, b)
    b_o = _mask(odd, b)
    # rhs_e = b_e - (1/a) D_eo b_o
    h_bo = _mask(even, cplx.add(apply_wilson(op, b_o), _scale(-a, b_o)))
    rhs = cplx.add(b_e, _scale(-1.0 / a, h_bo))

    x, rs = schur_cg(lambda v: schur_matvec(op, a, even, odd, v),
                     lambda v: _schur_matvec_dagger(op_h, a, even, odd, v), rhs, n_iters)
    psi_e = _mask(even, x)
    # psi_o = (b_o - D_oe psi_e) / a
    h_pe = _mask(odd, cplx.add(apply_wilson(op, psi_e), _scale(-a, psi_e)))
    psi_o = _scale(1.0 / a, cplx.add(b_o, _scale(-1.0, h_pe)))
    return cplx.add(psi_e, psi_o), rs
