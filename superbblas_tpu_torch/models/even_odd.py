"""Even-odd (red-black) preconditioned Wilson solves (counterpart of
``superbblas_tpu/models/even_odd.py``).

With sites checkerboarded into even/odd, the Wilson matrix is

    D = [[ a I   , D_eo ],        a = m + 4 r   (site-diagonal part)
         [ D_oe  , a I  ]]

and solving D psi = b reduces to the half-size Schur system

    Dhat psi_e = b_e - (1/a) D_eo b_o,   Dhat = a - (1/a) D_eo D_oe,

with psi_o = (b_o - D_oe psi_e) / a reconstructed site-locally.

Ported here: the Schur CG shared by the solves (``schur_cg``) and the
parity masks.  The packed half-lattice solve on the SoA stencil is
``models/eo_packed.py``; the masked full-lattice ``eo_solve`` and
``schur_matvec`` need the AoS stencil mode and are still to port
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .wilson import _axpy, _inner, _zeros_like

__all__ = ["checkerboard_masks", "schur_cg"]


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


def checkerboard_masks(lat_dims: Tuple[int, ...], trailing: int, device="cuda"):
    """(even, odd) 0/1 f32 masks shaped [*lat] + [1]*trailing, built with
    numpy and put on ``device``: the card unless the caller names the CPU."""
    coords = np.meshgrid(*[np.arange(d) for d in lat_dims], indexing="ij")
    par = sum(coords) % 2
    even = (par == 0).astype(np.float32)
    shape = tuple(lat_dims) + (1,) * trailing
    even = torch.from_numpy(even.reshape(shape)).to(device)
    return even, 1.0 - even
