"""Core/halo split stencil application with comm/compute overlap
(counterpart of ``superbblas_tpu/parallel/overlap.py``).

The reference overlaps communication and computation by splitting the
lattice operator into a *core* operator (connections that stay inside the
local domain, applied with ``just_local`` so no messages are posted,
bsr.h:2353-2359) and a *halo* operator (connections crossing the domain
boundary, applied after the exchange completes) — the scheme of
``create_lattice_split`` in the reference test driver (tests/bsr.cpp:402-530).

On each rank:

  1. the boundary slabs are posted with ``all_to_all_single(...,
     async_op=True)`` (halo.post_halos);
  2. the **core** contribution is the stencil matvec with cross-boundary
     neighbour operands zero-filled instead of rolled — it does not read
     the exchange, so it runs while the halo is in flight;
  3. the exchange is waited on, and the **halo** contribution adds, per
     crossing direction, the edge-slab micro-matvec against the received
     slab.

``just_local=True`` returns only step 2 — the reference's ``just_local``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import cplx
from ..bsr import BSROperator, _acc_dtype, _apply_gather, _apply_gather_kron, \
    _apply_stencil, _astype, _idx, _reshape
from ..labels import check_order
from ..ops.copy import _is_static, local_permute
from ._local import local_slab
from .halo import post_halos
from .mesh import axis_size
from .powers import _local_cols, _prepare, _wrap

__all__ = ["bsr_krylov_overlap"]


def _zshift(a, ax: int, o: int):
    """y[i] = a[i + o] with zero fill (no wraparound)."""
    L = a.shape[ax]
    if abs(o) >= L:
        return torch.zeros_like(a)
    pad_shape = a.shape[:ax] + (abs(o),) + a.shape[ax + 1:]
    zeros = torch.zeros(pad_shape, dtype=a.dtype, device=a.device)
    if o > 0:
        return torch.cat([a.narrow(ax, o, L - o), zeros], dim=ax)
    return torch.cat([zeros, a.narrow(ax, 0, L + o)], dim=ax)


def _shift_core(x, off, nlat, zero_axes):
    """Neighbour fetch of the core matvec: toroidal roll on local axes,
    zero fill across shard boundaries."""

    def sh(a):
        for ax, o in enumerate(off):
            if ax in zero_axes:
                if o != 0:
                    a = _zshift(a, ax, o)
            elif o % a.shape[ax] != 0:
                a = torch.roll(a, -o, dims=ax)
        return a

    return cplx.cmap(sh, x) if cplx.is_carray(x) else sh(x)


def _dir_contribution(op: BSROperator, blk_slab, xs_slab, k: int, nlat: int):
    """Contribution of direction k on an edge slab.

    blk_slab: [*slab, BI, BD]; xs_slab: [*slab, KD?, BD, N].
    Returns [*slab, KI?, BI, N] as ``_apply_stencil`` lays it out."""
    batch = tuple(range(nlat))
    acc = _acc_dtype(torch.promote_types(op.blocks_re.dtype, xs_slab.dtype))
    if op.kron is None:
        y = cplx.cdot_general(blk_slab, xs_slab, (((nlat + 1,), (nlat,)), (batch, batch)),
                              preferred_element_type=acc)
        return _astype(y, xs_slab.dtype)
    t = _astype(cplx.cdot_general(blk_slab, xs_slab,
                                  (((nlat + 1,), (nlat + 1,)), (batch, batch)),
                                  preferred_element_type=acc), xs_slab.dtype)

    def spin(kk, tt):
        dt = torch.promote_types(kk.dtype, tt.dtype)
        with cplx._full_f32():
            return torch.einsum("ab,...ibn->...ian", kk.to(dt), tt.to(dt))

    yk = cplx.cbilinear(spin, _idx(op.kron, k), t)          # [*slab, BI, KI, N]
    sw = lambda v: v.transpose(nlat, nlat + 1)  # noqa: E731
    return cplx.cmap(sw, yk) if cplx.is_carray(yk) else sw(yk)


def bsr_krylov_overlap(
    alpha,
    op: BSROperator,
    x,
    ox: str,
    mesh,
    axes: Dict[str, Optional[str]],
    beta=0.0,
    y=None,
    oy: Optional[str] = None,
    just_local: bool = False,
):
    """y = alpha * A x (+ beta * y) with an explicit core/halo split.

    Same semantics as ``bsr_krylov`` on a stencil (or gather) operator
    whose sharded lattice axes are given by ``axes`` (label -> mesh axis
    name); ``x`` is a DTensor (or CArray of them) sharded so, or a plain
    tensor every rank holds, and so is ``y``.  The halo exchange is
    posted asynchronously and overlapped with the core matvec.
    ``just_local=True`` skips the exchange and returns only the core
    contribution (reference ``just_local``, bsr.h:2353-2359)."""
    if op.mode not in ("stencil", "gather"):
        raise ValueError("the overlap path runs on stencil or gather "
                         "operators; SoA operators have "
                         "apply_stencil_soa_sharded")
    cols = "".join(c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
    if oy is None:
        oy = op.lat_i + op.kron_i + op.blk_i + cols
    check_order(oy)
    xc, shard, cols, col_shape, user_complex, col_axes = _prepare(op, x, ox, mesh, axes)
    nlat = len(op.dim_d)

    if op.mode == "gather":
        if shard:
            from .gather_sharded import _gather_overlap_local

            yc = _gather_overlap_local(op, xc, mesh, shard, just_local=just_local)
        else:
            fn = _apply_gather_kron if op.kron is not None else _apply_gather
            yc = fn(op, xc)
        return _finish_overlap(op, oy, cols, col_shape, alpha, beta, y, yc, shard, mesh,
                               user_complex, col_axes)

    radius = [max((abs(o[ax]) for o in op.offsets), default=0) for ax in range(nlat)]
    ax_names: Dict[int, str] = {}
    for ax, nm in shard.items():
        c = op.lat_d[ax]
        if radius[ax] == 0:
            continue
        if op.dim_d[ax] % axis_size(mesh, nm):
            raise ValueError(
                f"lattice axis {c!r} must divide evenly over mesh axis {nm!r}")
        if radius[ax] > op.dim_d[ax] // axis_size(mesh, nm):
            raise ValueError("stencil radius exceeds the local shard extent")
        ax_names[ax] = nm
    for off in op.offsets:
        if len([ax for ax in ax_names if off[ax] != 0]) > 1:
            raise NotImplementedError(
                "corner-crossing stencil directions (offsets along two "
                "sharded axes) are not supported by the overlap path")

    loc_dim = tuple(xc.shape[:nlat])
    blocks_l = local_slab(op.blocks, mesh, shard)
    lop = op.replace(blocks=blocks_l, dim=loc_dim)
    parts = list(xc) if cplx.is_carray(xc) else [xc]

    # 1. post the boundary slabs (async all_to_all_single per axis)
    posted = {} if just_local else {
        ax: post_halos(parts, ax, nm, radius[ax], mesh, async_op=True)
        for ax, nm in ax_names.items()}
    # 2. core matvec: no dependence on the exchange
    core = _apply_stencil(lop, xc, shift=lambda v, off, nl: _shift_core(v, off, nl,
                                                                        set(ax_names)))
    if not just_local:
        halos = {}
        for ax, work in posted.items():
            got = work.wait()
            lo = [g[0] for g in got]
            hi = [g[1] for g in got]
            pack = (lambda v: cplx.CArray(*v)) if cplx.is_carray(xc) else (lambda v: v[0])
            halos[ax] = (pack(lo), pack(hi))
        # 3. halo contributions per crossing direction
        for k, off in enumerate(op.offsets):
            crossing = [ax for ax in ax_names if off[ax] != 0]
            if not crossing:
                continue
            ax = crossing[0]
            s, w, L = off[ax], radius[ax], loc_dim[ax]
            low_halo, high_halo = halos[ax]

            def hal_slice(a, ax=ax, s=s, w=w):
                return a.narrow(ax, 0, s) if s > 0 else a.narrow(ax, w + s, -s)

            src = high_halo if s > 0 else low_halo
            hal = cplx.cmap(hal_slice, src) if cplx.is_carray(src) else hal_slice(src)
            off_rest = tuple(0 if a == ax else o for a, o in enumerate(off))
            if any(off_rest):
                def roll_rest(a, off_rest=off_rest):
                    for a2, o in enumerate(off_rest):
                        if o % a.shape[a2] != 0:
                            a = torch.roll(a, -o, dims=a2)
                    return a
                hal = cplx.cmap(roll_rest, hal) if cplx.is_carray(hal) else roll_rest(hal)
            slab_sl = [slice(None)] * nlat
            slab_sl[ax] = slice(L - s, L) if s > 0 else slice(0, -s)
            blk_slab = _idx(lop.blocks, tuple(slab_sl) + (k,))
            contrib = _dir_contribution(lop, blk_slab, hal, k, nlat)
            idx = tuple(slab_sl)

            def add_at(c, t, idx=idx):
                c = c.clone()
                c[idx] += t
                return c

            core = cplx.cmap(add_at, core, contrib) if cplx.is_carray(core) \
                else add_at(core, contrib)
    return _finish_overlap(op, oy, cols, col_shape, alpha, beta, y, core, shard, mesh,
                           user_complex, col_axes)


def _finish_overlap(op, oy, cols, col_shape, alpha, beta, y, yc, shard, mesh, user_complex,
                    col_axes=None):
    """Shared tail: the canonical [*lat_loc, KI?, BI, N] result in the
    user's oy labels, scaled, beta*y added (y's local slab), complex
    restored, wrapped sharded."""
    lat_loc = tuple(yc.shape[:len(op.dim_i)])
    ki_shape = tuple(op.ki) if op.kron is not None else ()
    shape = lat_loc + ki_shape + tuple(op.bi) + _local_cols(cols, col_shape, col_axes or {},
                                                            mesh)
    canon_y = op.lat_i + op.kron_i + op.blk_i + cols
    out = local_permute(_reshape(yc, shape), canon_y, oy)
    if not (_is_static(alpha) and alpha == 1):
        out = cplx.scale(alpha, out)
    if y is not None and not (_is_static(beta) and beta == 0):
        yl = local_slab(y, mesh, {oy.index(op.lat_i[k]): nm for k, nm in shard.items()})
        if user_complex and not cplx.is_carray(yl):
            yl = cplx.from_complex(yl)
        out = cplx.add(out, cplx.scale(beta, yl))
    col_in_oy = tuple(col_shape[cols.index(c)] for c in oy if c in cols)
    return _wrap(op, out, oy, shard, mesh, (), col_in_oy, user_complex, col_axes=col_axes)
