"""Even-odd preconditioned Wilson-clover operator on packed half lattices
(the port's own: the JAX package has no clover even-odd path).

With the sites split by parity, the Wilson-clover operator is

    D = [[ A_ee , H_eo ],      A = (m + 4 r) + clover term: one Hermitian
         [ H_oe , A_oo ]]          12x12 block a site, commuting with g5

and D x = b reduces to the Schur system on the even sites (openQCD's
``Dwhat``, Luescher's even-odd preconditioning of the clover operator)

    Dhat x_e = b_e - H_eo A_oo^-1 b_o,   Dhat = A_ee - H_eo A_oo^-1 H_oe,

with x_o = A_oo^-1 (b_o - H_oe x_e) reconstructed site by site.  Dhat is
g5-Hermitian (A commutes with g5 and g5 H g5 = H^H), so Dhat^H = g5 Dhat
g5.

Every field and block is packed by parity (``eo_packed.cb_pack_soa``: X
halved).  The hopping term runs on K1's tiled route with
``packed_parity`` (``hopping_packed_soa``, the centre dropped); the site
blocks A_ee and A_oo^-1 are centre-only (1, 1, 12, 12) stencils on the
half lattice, K1's block-streaming route.  A_oo^-1 is formed once, in
complex128 by ``dense.inversion``, then cast to the blocks' type.  SoA
fields [n, 12, X/2, Y, Z, T] on one device; DTensor operands raise.

For the tracker: each ``apply_schur`` is a span (host and device) and one
``schur.applies``; ``eo_prepare`` and ``eo_reconstruct`` are host spans
``eo.prepare`` and ``eo.reconstruct``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import cplx, dense, solvers
from ..bsr import BSROperator, apply_stencil_soa
from ..cplx import CArray
from ..ops._guard import is_sharded
from ..utils import tracker
from .clover import CloverOperator
from .eo_packed import cb_pack_soa, cb_unpack_soa, hopping_packed_soa
from .wilson import NC, NS, gamma5

__all__ = ["CloverEOOperator", "clover_eo_operator", "apply_schur", "eo_prepare",
           "eo_reconstruct", "eo_solve_clover_soa"]

#: site blocks a batch of the complex128 inversion (302 MB of blocks)
INVERT_BATCH = 1 << 17


@dataclass(frozen=True)
class CloverEOOperator:
    """The packed pieces of D: the hopping term onto each parity (from the
    other), A_ee and A_oo^-1 on the half lattice, and g5's signs over the
    12 spin-colour features."""

    hop_e: BSROperator
    hop_o: BSROperator
    site_e: BSROperator
    site_o_inv: BSROperator
    signs: torch.Tensor


def _refuse_sharded(name: str, *operands) -> None:
    if is_sharded(*operands):
        raise ValueError(f"{name}: the clover even-odd path runs on one device; a sharded "
                         "DTensor operand is not taken")


def _site_blocks(op: CloverOperator, parity: int) -> torch.Tensor:
    """A on the ``parity`` sites, complex128 [V/2, 12, 12]: the hopping
    operator's centre direction (its spin factor (x) its colour block)
    plus the clover term."""
    hop = op.hop
    c = hop.offsets.index((0,) * len(hop.dim_d))
    kron = torch.complex(hop.kron_re[c], hop.kron_im[c]).to(torch.complex128)
    centre = cb_pack_soa(CArray(hop.blocks_re[c:c + 1], hop.blocks_im[c:c + 1]), parity)
    B = torch.complex(*centre).to(torch.complex128).reshape(3, 3, -1)
    del centre
    A = torch.einsum("st,abv->vsatb", kron, B).reshape(-1, 12, 12)
    del B
    cl = cb_pack_soa(CArray(op.clover.blocks_re, op.clover.blocks_im), parity)
    A += torch.complex(*cl).to(torch.complex128).reshape(12, 12, -1).permute(2, 0, 1)
    return A


def _site_operator(op: CloverOperator, A: torch.Tensor, half) -> BSROperator:
    """A centre-only stencil of the site blocks ``A`` [V/2, 12, 12] on the
    half lattice ``half``, in the clover term's block type."""
    dt = op.clover.blocks_re.dtype
    blocks = A.permute(1, 2, 0).reshape((1, 144) + half)
    return op.clover.replace(blocks=CArray(blocks.real.to(dt).contiguous(),
                                           blocks.imag.to(dt).contiguous()), dim=half)


def clover_eo_operator(op: CloverOperator) -> CloverEOOperator:
    """The packed even-odd pieces of an SoA clover operator, on its device.
    The result holds nothing of ``op``: a caller that drops ``op`` frees the
    unpacked blocks."""
    if op.hop.mode != "stencil_soa":
        raise ValueError("the clover even-odd path needs an operator built with layout='soa'")
    _refuse_sharded("clover_eo_operator", op.hop.blocks_re, op.clover.blocks_re)
    half = (op.hop.dim_d[0] // 2,) + tuple(op.hop.dim_d[1:])
    site_e = _site_operator(op, _site_blocks(op, 0), half)
    A = _site_blocks(op, 1)
    for a in A.split(INVERT_BATCH):
        a.copy_(dense.inversion(a, "vrc", "r", "c"))
    site_o_inv = _site_operator(op, A, half)
    del A
    # gamma5 is diagonal in this basis: its spin signs, repeated over colour
    signs = torch.as_tensor(np.repeat(np.diagonal(gamma5()).real, NC),
                            dtype=op.hop.blocks_re.dtype, device=op.hop.blocks_re.device)
    signs = signs.reshape(1, NS * NC, 1, 1, 1, 1)
    return CloverEOOperator(hop_e=hopping_packed_soa(op.hop, 0),
                            hop_o=hopping_packed_soa(op.hop, 1),
                            site_e=site_e, site_o_inv=site_o_inv, signs=signs)


def _g5(eo: CloverEOOperator, v: CArray) -> CArray:
    return cplx.cmap(lambda a: a * eo.signs, v)


def _sub_(y: CArray, t: CArray) -> CArray:
    """y - t, written into y (a fresh output of the caller's)."""
    y.re.sub_(t.re)
    y.im.sub_(t.im)
    return y


@tracker.spanned("apply_schur")
def apply_schur(eo: CloverEOOperator, v_e: CArray) -> CArray:
    """Dhat v_e = A_ee v_e - H_eo A_oo^-1 H_oe v_e on the even half lattice:
    two packed hopping launches, two site-block launches, one subtraction."""
    _refuse_sharded("apply_schur", tuple(v_e))
    tracker.count("schur.applies")
    t = apply_stencil_soa(eo.hop_o, v_e, packed_parity=1)
    t = apply_stencil_soa(eo.site_o_inv, t)
    t = apply_stencil_soa(eo.hop_e, t, packed_parity=0)
    return _sub_(apply_stencil_soa(eo.site_e, v_e), t)


@tracker.spanned("eo.prepare", events=False)
def eo_prepare(eo: CloverEOOperator, b: CArray) -> CArray:
    """The Schur system's right-hand side b_e - H_eo A_oo^-1 b_o from the
    full SoA ``b`` [n, 12, X, Y, Z, T]."""
    _refuse_sharded("eo_prepare", tuple(b))
    t = apply_stencil_soa(eo.site_o_inv, cb_pack_soa(b, 1))
    t = apply_stencil_soa(eo.hop_e, t, packed_parity=0)
    return _sub_(cb_pack_soa(b, 0), t)


@tracker.spanned("eo.reconstruct", events=False)
def eo_reconstruct(eo: CloverEOOperator, x_e: CArray, b: CArray) -> CArray:
    """The full solution in the SoA layout: x_e and x_o = A_oo^-1 (b_o -
    H_oe x_e)."""
    _refuse_sharded("eo_reconstruct", tuple(x_e), tuple(b))
    t = apply_stencil_soa(eo.hop_o, x_e, packed_parity=1)
    x_o = apply_stencil_soa(eo.site_o_inv, _sub_(cb_pack_soa(b, 1), t))
    return cb_unpack_soa(x_e, x_o)


def eo_solve_clover_soa(eo: CloverEOOperator, b: CArray, tol: float = 1e-5,
                        maxiter: int = 500):
    """D x = b through the Schur system: ``solvers.cgne`` over Dhat and
    Dhat^H = g5 Dhat g5 to ``tol`` on the Schur system's normal residual,
    then the odd sites.  Returns (x in the SoA layout, |r|^2 of the Schur
    CG, iterations), as ``solvers.cgne`` returns them."""
    x_e, rs, k = solvers.cgne(lambda v: apply_schur(eo, v),
                              lambda v: _g5(eo, apply_schur(eo, _g5(eo, v))),
                              eo_prepare(eo, b), tol=tol, maxiter=maxiter)
    return eo_reconstruct(eo, x_e, b), rs, k
