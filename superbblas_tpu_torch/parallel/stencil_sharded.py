"""Sharded execution of the SoA stencil kernel (counterpart of
``superbblas_tpu/parallel/stencil_sharded.py``).

The SoA kernel (K1) does not partition itself, so the multi-rank path is
explicit: on each rank

  1. one exchange per sharded lattice axis moves a halo shell of width
     ``power`` x the stencil radius, for the blocks and x together;
  2. K1 runs on the locally extended block (``bsr.apply_stencil_soa``):
     its internal toroidal wraps are wrong only in the outermost shell,
     which is exactly the halo (the shell-contamination argument of
     parallel/powers.py), and ``power`` applications follow the one
     exchange (the communication-avoiding okr scheme);
  3. the exact core is cropped and returned as a DTensor with the input's
     sharding.

The blocks are halo-extended on every call, as in the JAX package.

Constraints: only the first two lattice axes (X, Y) may be sharded, they
divide evenly, and the halo width is at most the local extent.
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import cplx
from ..bsr import BSROperator, apply_stencil_soa
from ._local import from_local, local
from .halo import crop_halos, extend_local as _extend
from .mesh import axis_size

__all__ = ["apply_stencil_soa_sharded"]


def apply_stencil_soa_sharded(
    op: BSROperator,
    x: cplx.CArray,
    mesh,
    axes: Dict[str, Optional[str]],
    power: int = 1,
    interpret: Optional[bool] = None,
):
    """y = A^power x on a lattice-sharded SoA operand through K1 (one halo
    exchange per sharded axis in all).

    ``x``: CArray of DTensors [n, KD*BD, X, Y, Z, T] sharded on lattice
    axes per ``axes`` (lattice label -> mesh axis; only the first two
    lattice axes may be sharded) over ``mesh`` (a DeviceMesh).  ``op``
    must be an SoA operator whose blocks are sharded the same way (its
    kron replicated: a plain tensor).  Returns [n, KI*BI, X, Y, Z, T]
    with the input sharding.  ``interpret`` is accepted and unused."""
    if op.mode != "stencil_soa":
        raise ValueError("requires an SoA-layout stencil operator")
    nlat = len(op.dim_d)
    radius = [max((abs(o[ax]) for o in op.offsets), default=0)
              for ax in range(nlat)]
    ax_names: Dict[int, str] = {}
    widths: Dict[int, int] = {}
    for k, c in enumerate(op.lat_d):
        nm = axes.get(c)
        if nm is None or axis_size(mesh, nm) == 1 or radius[k] == 0:
            continue
        if k >= 2:
            raise ValueError(
                "only the first two lattice axes (X, Y) may be sharded: "
                "Z/T ride the kernel's register tiles")
        if op.dim_d[k] % axis_size(mesh, nm):
            raise ValueError(f"lattice axis {c!r} must divide evenly")
        w = power * radius[k]
        if w > op.dim_d[k] // axis_size(mesh, nm):
            raise ValueError("halo width exceeds the local shard extent")
        ax_names[2 + k] = nm
        widths[2 + k] = w

    blocks_e, x_e = _extend([local(op.blocks), local(x)], ax_names, widths, mesh)
    loc_dim = tuple(x_e.re.shape[2:])
    lop = op.replace(blocks=blocks_e, kron=local(op.kron), dim=loc_dim)
    cur = x_e
    for _ in range(power):
        cur = apply_stencil_soa(lop, cur)
    y = crop_halos(cur, widths)
    shape = (x.re.shape[0], y.re.shape[1]) + tuple(op.dim_i)
    return from_local(y, x, shape)
