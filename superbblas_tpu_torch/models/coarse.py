"""Coarse-grid (multigrid) lattice operator: large dense blocks on a small
lattice (counterpart of ``superbblas_tpu/models/coarse.py``).

Multigrid solvers coarsen the Dirac operator onto a small lattice with
large dense blocks (N_c = 2 x the number of near-null vectors, typically
24-64) and no Kronecker factor.  Its apply is the AoS no-kron stencil of
``bsr.py``: the ndir shifted operands stacked into one batched product
with J = ndir * N_c per site, on the batched-GEMM kernels of
``ops/batched_gemm.py`` (three launches an apply, the split-complex Gauss
products).  A Galerkin operator of the clover multigrid
(``multigrid.galerkin_coarse_operator``) is held in mode "gather", its
blocks already in that product's layout.

The generated operator is Hermitian (A_{-mu}(s + mu) = A_{+mu}(s)^H) with
the mass on the diagonal, the property coarse operators inherit from
Galerkin coarsening.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..bsr import BSROperator, bsr_from_stencil, bsr_krylov
from ..cplx import CArray
from ..utils import tracker
from .wilson import _seed_from_key

__all__ = ["coarse_operator", "apply_coarse"]


def coarse_operator(
    lat_dims: Tuple[int, ...],
    block_size: int = 32,
    mass: float = 0.1,
    key=None,
    dtype=torch.complex64,
    device="cuda",
) -> BSROperator:
    """Random Hermitian coarse operator in the AoS layout: centre m*I plus a
    Hermitian site-local term, and Hermitian-paired nearest-neighbour
    blocks.  The blocks come from numpy's generator seeded with ``key``,
    by the JAX package's code, so both build the same operator bit for bit.
    Built on ``device``: the card unless the caller names the CPU."""
    nd = len(lat_dims)
    rng = np.random.default_rng(_seed_from_key(key))
    nc = block_size

    def rand_blocks():
        a = (rng.standard_normal(tuple(lat_dims) + (nc, nc))
             + 1j * rng.standard_normal(tuple(lat_dims) + (nc, nc)))
        return a / np.sqrt(nc)

    eye = np.broadcast_to(np.eye(nc, dtype=np.complex128),
                          tuple(lat_dims) + (nc, nc))
    center = mass * eye + 0j
    # Hermitian site-local correction
    h = rand_blocks()
    center = center + 0.5 * (h + np.swapaxes(h, -1, -2).conj())

    offsets = [(0,) * nd]
    blocks = [center]
    for mu in range(nd):
        fwd = [0] * nd
        fwd[mu] = 1
        a = rand_blocks()
        offsets.append(tuple(fwd))
        blocks.append(a)
        bwd = [0] * nd
        bwd[mu] = -1
        offsets.append(tuple(bwd))
        # A_{-mu}(s) = A_{+mu}(s - mu)^H  -> overall Hermitian operator
        blocks.append(np.swapaxes(np.roll(a, 1, axis=mu), -1, -2).conj())

    part_dt = np.float32 if dtype == torch.complex64 else np.float64
    vals = np.stack(blocks, axis=nd)
    lat_labels = "xyzt"[:nd]
    return bsr_from_stencil(
        lat_labels + "c", lat_labels + "C",
        lat_dims, {"c": nc}, {"C": nc},
        offsets,
        CArray(vals.real.astype(part_dt), vals.imag.astype(part_dt)),
        layout="aos", device=device,
    )


@tracker.spanned("coarse.apply")
def apply_coarse(op: BSROperator, x):
    """y = A x; x: [*lat, N_c, ncols] (CArray or complex).  Each call is a
    ``coarse.apply`` span of the tracker."""
    nd = len(op.dim_d)
    return bsr_krylov(1.0, op, x, "xyzt"[:nd] + "Cn")
