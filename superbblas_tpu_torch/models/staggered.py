"""Staggered (Kogut-Susskind) fermion operator (counterpart of
``superbblas_tpu/models/staggered.py``):

    D x(s) = m x(s)
             + 1/2 sum_mu eta_mu(s) [ U_mu(s) x(s+mu) - U_mu(s-mu)^H x(s-mu) ]

with the Kawamoto-Smit phases eta_mu(s) = (-1)^(s_0 + ... + s_{mu-1}).
There is no spin: the blocks are 3x3 colour matrices with no spin factor,
so the SoA layout runs the stencil kernel at (KI, KD, BI, BD) = (1, 1, 3,
3) with 9 directions, and the AoS layout one batched product of J = 27
(K3).  The hopping part is anti-Hermitian, so solves run CG on D^H D.
The blocks are formed on the operator's device from numpy links, with
the JAX package's exact operations (bit-identical blocks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..bsr import BSROperator, apply_stencil_soa, bsr_from_stencil, bsr_krylov
from .wilson import NC, _seed_from_key, link_dagger_behind, links_tensor, random_su3_links, \
    real_parts

__all__ = ["staggered_operator", "apply_staggered", "eta_phases"]


def eta_phases(lat_dims: Tuple[int, ...]) -> np.ndarray:
    """eta[mu, *lat] = (-1)^(s_0 + ... + s_{mu-1})."""
    nd = len(lat_dims)
    coords = np.meshgrid(*[np.arange(d) for d in lat_dims], indexing="ij")
    eta = np.ones((nd,) + tuple(lat_dims))
    acc = np.zeros(tuple(lat_dims), dtype=np.int64)
    for mu in range(nd):
        eta[mu] = (-1.0) ** (acc % 2)
        acc = acc + coords[mu]
    return eta


def staggered_operator(
    lat_dims: Tuple[int, ...],
    mass: float = 0.1,
    key: Optional[int] = None,
    dtype=torch.complex64,
    links: Optional[np.ndarray] = None,
    layout: str = "soa",
    device="cuda",
) -> BSROperator:
    """Build the staggered operator as a plain (no spin factor) stencil.

    Labels: lattice "xyzt"[:nd], colour "c" (image) / "C" (domain).
    ``layout="soa"`` (the default here; the JAX package's is "aos") runs
    the stencil kernel on [ncols, 3, *lat]; ``layout="aos"`` takes
    [*lat, 3, ncols] through ``bsr_krylov``.  ``links`` are numpy
    [nd, *lat, 3, 3] (None: random from ``key``).  The operator is built
    on ``device``: the card unless the caller names the CPU."""
    nd = len(lat_dims)
    rng = np.random.default_rng(_seed_from_key(key))
    if links is None:
        links = random_su3_links(rng, lat_dims)   # [mu, *lat, 3, 3]
    U = links_tensor(links, device)
    eta = torch.as_tensor(eta_phases(lat_dims), device=U.device)[..., None, None]
    eye_c = torch.eye(NC, dtype=torch.complex128, device=U.device).expand(
        tuple(lat_dims) + (NC, NC))

    offsets = [(0,) * nd]
    blocks = [mass * eye_c]
    for mu in range(nd):
        fwd = [0] * nd
        fwd[mu] = 1
        offsets.append(tuple(fwd))
        blocks.append(0.5 * eta[mu] * U[mu])
        bwd = [0] * nd
        bwd[mu] = -1
        offsets.append(tuple(bwd))
        blocks.append(-0.5 * eta[mu] * link_dagger_behind(U, mu))
    del U

    lat_labels = "xyzt"[:nd]
    return bsr_from_stencil(
        lat_labels + "c", lat_labels + "C",
        lat_dims, {"c": NC}, {"C": NC},
        offsets, real_parts(torch.stack(blocks, dim=nd), dtype),
        layout=layout, device=device,
    )


def apply_staggered(op: BSROperator, x):
    """y = D x.  AoS operators take [*lat, NC, ncols] (CArray or complex);
    SoA operators [ncols, NC, *lat] CArrays."""
    if op.mode == "stencil_soa":
        return apply_stencil_soa(op, x)
    return bsr_krylov(1.0, op, x, "xyzt"[:len(op.dim_d)] + "Cn")
