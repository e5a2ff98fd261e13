"""Sharded execution of the SoA stencil kernel (counterpart of
``superbblas_tpu/parallel/stencil_sharded.py``).

The SoA kernel (K1) does not partition itself, so the multi-rank path is
explicit: on each rank

  1. one exchange per sharded lattice axis moves a halo shell of width
     ``power`` x the stencil radius of x, and at an operator's first
     apply of its blocks too (``halo.extend_held``: the extended blocks
     are held for the applies after it);
  2. K1 runs on the locally extended block (``bsr.apply_stencil_soa``):
     its internal toroidal wraps are wrong only in the outermost shell,
     which is exactly the halo (the shell-contamination argument of
     parallel/powers.py), and ``power`` applications follow the one
     exchange (the communication-avoiding okr scheme);
  3. the exact core is cropped and returned as a DTensor with the input's
     sharding.

The JAX package extends the blocks on every call; here they are
extended once for each operator, mesh axis and halo width, and rebuilt
after an in-place change.  Blocks every rank holds whole (plain tensors)
are cut to the rank's slab first, and held by the tensor they are cut
from; blocks that are DTensors shard the lattice as x does.  A sharded
column axis (x's first) needs no exchange: K1 runs on the local columns.
With ``packed_parity`` the field holds one checkerboard parity, X halved:
K1 reads a site's parity from its coordinates in the extended block, so
the wrapper is given the parity as seen from that block's origin (the
to-parity flipped where the origin's y + z + t is odd).

Constraints: only the first two lattice axes (X, Y) may be sharded with
a radius, they divide evenly, and the halo width is at most the local
extent.
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import cplx
from ..bsr import BSROperator, apply_stencil_soa
from ._local import from_local, local, mesh_axes
from .halo import crop_halos, extend_held
from .mesh import axis_size

__all__ = ["apply_stencil_soa_sharded"]


def _soa_local(op: BSROperator, xl, mesh, axes: Dict[str, Optional[str]], power: int = 1,
               packed_parity: Optional[int] = None):
    """This rank's part of y = A^power x: ``xl`` is the rank's local shard
    [n_loc, KD*BD, *lat_loc] of a field sharded on the lattice per ``axes``
    (lattice label -> mesh axis); returns the local [n_loc, KI*BI,
    *lat_loc]."""
    nlat = len(op.dim_d)
    radius = [max((abs(o[ax]) for o in op.offsets), default=0)
              for ax in range(nlat)]
    ax_names: Dict[int, str] = {}
    widths: Dict[int, int] = {}
    cut: Dict[int, str] = {}
    origin_par = 0
    for k, c in enumerate(op.lat_d):
        nm = axes.get(c)
        if nm is None or axis_size(mesh, nm) == 1:
            continue
        n = axis_size(mesh, nm)
        if op.dim_d[k] % n:
            raise ValueError(f"lattice axis {c!r} must divide evenly")
        cut[2 + k] = nm
        if radius[k] == 0:
            continue
        if k >= 2:
            raise ValueError(
                "only the first two lattice axes (X, Y) may be sharded: "
                "Z/T ride the kernel's register tiles")
        w = power * radius[k]
        if w > op.dim_d[k] // n:
            raise ValueError("halo width exceeds the local shard extent")
        ax_names[2 + k] = nm
        widths[2 + k] = w
        if k > 0:
            origin_par += mesh.get_local_rank(nm) * (op.dim_d[k] // n) - w
    for k, nm in cut.items():
        if k not in widths and k > 2:
            origin_par += mesh.get_local_rank(nm) * (op.dim_d[k - 2] // axis_size(mesh, nm))
    blocks_e, x_e = extend_held(op.blocks, cut, xl, ax_names, widths, mesh)
    loc_dim = tuple(x_e.re.shape[2:])
    lop = op.replace(blocks=blocks_e, kron=local(op.kron), dim=loc_dim)
    parity = None if packed_parity is None else (int(packed_parity) + origin_par) % 2
    cur = x_e
    for _ in range(power):
        cur = apply_stencil_soa(lop, cur, packed_parity=parity)
    return crop_halos(cur, widths)


def apply_stencil_soa_sharded(
    op: BSROperator,
    x: cplx.CArray,
    mesh,
    axes: Dict[str, Optional[str]],
    power: int = 1,
    interpret: Optional[bool] = None,
    packed_parity: Optional[int] = None,
):
    """y = A^power x on a lattice-sharded SoA operand through K1 (one halo
    exchange per sharded axis in all).

    ``x``: CArray of DTensors [n, KD*BD, X, Y, Z, T] sharded on lattice
    axes per ``axes`` (lattice label -> mesh axis; only the first two
    lattice axes may be sharded), and on its columns over any other mesh
    axis, over ``mesh`` (a DeviceMesh).  ``op``'s blocks are a plain
    tensor every rank holds or DTensors sharded as x's lattice (its kron
    replicated: a plain tensor).  ``packed_parity`` (0 or 1): the
    operands hold one checkerboard parity with X halved, as for
    ``bsr.apply_stencil_soa``.  Returns [n, KI*BI, X, Y, Z, T] with the
    input sharding.  ``interpret`` is accepted and unused."""
    if op.mode != "stencil_soa":
        raise ValueError("requires an SoA-layout stencil operator")
    _, lab = mesh_axes(x, "nf" + op.lat_d)
    if "f" in lab:
        raise ValueError("the feature axis (spin x colour) of an SoA field cannot be "
                         "sharded")
    y = _soa_local(op, local(x), mesh, axes, power, packed_parity)
    shape = (x.re.shape[0], y.re.shape[1]) + tuple(op.dim_i)
    return from_local(y, x, shape)
