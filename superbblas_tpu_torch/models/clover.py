"""Wilson-clover operator: the Wilson stencil plus a site-local dense
12x12 term (counterpart of ``superbblas_tpu/models/clover.py``):

    D_cl = D_wilson - (c_sw / 2) sum_{mu<nu} sigma_{mu nu} (x) F~_{mu nu}(s)

with sigma_{mu nu} = (i/2)[gamma_mu, gamma_nu] and F~ the Hermitian
clover-leaf field strength (Q - Q^H) / (8 i), Q the sum of the four
plaquette leaves around the site.  The operator is two stencil operators
applied back to back: the Wilson Kron-BSR stencil and a centre-only
stencil whose block is the full spin (x) colour 12x12 matrix of each site.
In the SoA layout the clover term runs the stencil kernel at (KI, KD, BI,
BD) = (1, 1, 12, 12) on the same [ncols, 12, *lat] operand as the Wilson
term; in the AoS layout one batched product of J = 12 (K3).

The field strength and the clover blocks are formed with torch ops on the
operator's device, in complex128, then cast: at 24^3x48 the blocks take
1.5 GB in complex128, which the JAX package forms in host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import cplx
from ..bsr import BSROperator, apply_stencil_soa, bsr_from_stencil, bsr_krylov
from .wilson import NC, NS, _seed_from_key, apply_wilson, gamma_matrices, links_tensor, \
    random_su3_links, real_parts, wilson_operator

__all__ = ["CloverOperator", "wilson_clover_operator", "apply_clover",
           "clover_field_strength"]


def _roll(a: torch.Tensor, mu: int, k: int) -> torch.Tensor:
    """a(s) -> a(s + k*mu) (value at the shifted site), lattice axes lead."""
    return torch.roll(a, -k, dims=mu)


def _dag(u: torch.Tensor) -> torch.Tensor:
    return u.transpose(-1, -2).conj()


def clover_field_strength(links, mu: int, nu: int) -> torch.Tensor:
    """Hermitian clover-leaf F~_{mu nu}(s) = (Q - Q^H) / (8 i), [*lat, 3, 3]
    complex, on the device of ``links`` ([4, *lat, 3, 3], a complex tensor
    or numpy array)."""
    U = torch.as_tensor(links)

    def mm(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = out @ m
        return out

    # four leaves around the site (standard clover sum)
    q1 = mm(U[mu], _roll(U[nu], mu, 1), _dag(_roll(U[mu], nu, 1)), _dag(U[nu]))
    q2 = mm(U[nu], _dag(_roll(_roll(U[mu], mu, -1), nu, 1)),
            _dag(_roll(U[nu], mu, -1)), _roll(U[mu], mu, -1))
    q3 = mm(_dag(_roll(U[mu], mu, -1)),
            _dag(_roll(_roll(U[nu], mu, -1), nu, -1)),
            _roll(_roll(U[mu], mu, -1), nu, -1), _roll(U[nu], nu, -1))
    q4 = mm(_dag(_roll(U[nu], nu, -1)), _roll(U[mu], nu, -1),
            _roll(_roll(U[nu], mu, 1), nu, -1), _dag(U[mu]))
    q = q1 + q2 + q3 + q4
    return (q - _dag(q)) / 8j


@dataclass(frozen=True)
class CloverOperator:
    """hop (Wilson Kron-BSR) + clover (site-local 12x12 block stencil)."""

    hop: BSROperator
    clover: BSROperator
    c_sw: float

    @property
    def dim_i(self):
        return self.hop.dim_i

    def flops_per_matvec(self, ncols: int, complex_dtype: bool = True) -> int:
        return (self.hop.flops_per_matvec(ncols, complex_dtype)
                + self.clover.flops_per_matvec(ncols, complex_dtype))


def wilson_clover_operator(
    lat_dims: Tuple[int, ...],
    mass: float = 0.1,
    c_sw: float = 1.0,
    r: float = 1.0,
    key: Optional[int] = None,
    dtype=torch.complex64,
    links: Optional[np.ndarray] = None,
    layout: str = "soa",
    device="cuda",
) -> CloverOperator:
    """Build D_clover over random (``key``) or given numpy ``links``.

    Labels follow the Wilson convention: image "xyzt"+"Sc", domain
    "xyzt"+"SC", the clover term treating (S, c) as one 12x12 block.
    ``layout="soa"`` (the default here; the JAX package's is "aos") builds
    both terms in the SoA layout: ``apply_clover`` then takes [ncols, 12,
    *lat] CArrays.  The operator is built on ``device``: the card unless
    the caller names the CPU."""
    nd = len(lat_dims)
    if nd != 4:
        raise ValueError("the clover term is defined on a 4D lattice")
    rng = np.random.default_rng(_seed_from_key(key))
    if links is None:
        links = random_su3_links(rng, lat_dims)

    hop = wilson_operator(lat_dims, mass=mass, r=r, dtype=dtype, links=links,
                          layout=layout, device=device)

    g = gamma_matrices()
    U = links_tensor(links, device)
    cblk = torch.zeros(tuple(lat_dims) + (NS, NC, NS, NC), dtype=torch.complex128,
                       device=device)
    for mu in range(4):
        for nu in range(mu + 1, 4):
            s_mn = torch.as_tensor(0.5j * (g[mu] @ g[nu] - g[nu] @ g[mu]), device=device)
            f_mn = clover_field_strength(U, mu, nu)   # [*lat, 3, 3]
            cblk += -(c_sw / 2.0) * s_mn[:, None, :, None] * f_mn[..., None, :, None, :]
    del U
    parts = real_parts(cblk.reshape(tuple(lat_dims) + (1, NS * NC, NS * NC)), dtype)
    del cblk
    clover = bsr_from_stencil(
        "xyztSc", "xyztSC",
        lat_dims, {"S": NS, "c": NC}, {"S": NS, "C": NC},
        [(0, 0, 0, 0)], parts, layout=layout, device=device)
    return CloverOperator(hop=hop, clover=clover, c_sw=c_sw)


def apply_clover(op: CloverOperator, x):
    """y = D_clover x.  AoS operators take [*lat, NS, NC, ncols] (CArray or
    complex); SoA operators [ncols, 12, *lat] CArrays, both terms running
    the stencil kernel on the same operand."""
    y_hop = apply_wilson(op.hop, x)
    if op.hop.mode == "stencil_soa":
        return cplx.add(y_hop, apply_stencil_soa(op.clover, x))
    # the default image order "xyztScn" has the Wilson output's axes
    y_cl = bsr_krylov(1.0, op.clover, x, "xyztSCn")
    return cplx.add(y_hop, y_cl) if cplx.is_carray(y_hop) else y_hop + y_cl
