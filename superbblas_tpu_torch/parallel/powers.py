"""Communication-avoiding operator powers: ONE widened halo exchange
serving p stencil applications (counterpart of
``superbblas_tpu/parallel/powers.py``).

The reference implements this with the ``okr`` power label: the domain
partition is pre-extended by ``power`` neighbour shells (``ext_power``,
dist.h:3477-3509) so a single x-gather feeds all p local matvecs
(bsr.h:2140-2247).  On each rank:

  1. one exchange per sharded lattice axis moves a halo of width
     p * max|offset| (the field and the operator's blocks together);
  2. the stencil is applied p times on the locally extended block with
     plain local rolls — a local roll is wrong only inside the outermost
     shell, and the contamination creeps inward one shell per
     application, so the core is exact for all p outputs;
  3. each output is cropped to the core; the result is a DTensor sharded
     as the input.

Gather-mode operators route to the halo-plan executor
(gather_sharded.py).
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import cplx
from ..bsr import BSROperator, _apply_gather, _apply_gather_kron, _apply_stencil, _reshape, \
    _stack
from ..labels import check_order, volume
from ..ops.copy import _is_static, local_permute
from ._local import label_axes, local_slab, wrap_labels
from .halo import crop_halos as _crop, extend_local as _extend
from .mesh import axis_size

__all__ = ["bsr_krylov_ca"]


def _prepare(op: BSROperator, x, ox: str, mesh, axes):
    """Shared preamble of the sharded Krylov paths: this rank's canonical
    local operand [*lat_loc, KD?, BD, N_loc], the lattice axes sharded
    ({lattice axis: mesh axis}), the column labels, their global extents,
    whether the user passed complex data and the column labels x shards
    ({label: mesh axis}: they need no exchange)."""
    check_order(ox)
    shard = {k: axes[c] for k, c in enumerate(op.lat_d)
             if axes.get(c) is not None and axis_size(mesh, axes[c]) > 1}
    have = label_axes(x, ox)
    for k, nm in shard.items():
        c = op.lat_d[k]
        if c in have and have[c] != nm:
            raise ValueError(f"x shards {c!r} over {have[c]!r}, not {nm!r}")
    xl = local_slab(x, mesh, {ox.index(op.lat_d[k]): nm for k, nm in shard.items()
                              if op.lat_d[k] not in have})
    user_complex = not cplx.is_carray(xl) and xl.is_complex()
    if user_complex:
        xl = cplx.from_complex(xl)
    cols = "".join(c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
    col_axes = {c: nm for c, nm in have.items() if c in cols}
    canon_x = op.lat_d + op.kron_d + op.blk_d + cols
    xc = local_permute(xl, ox, canon_x)
    nlat = len(op.dim_d)
    lat_shape = tuple(xc.shape[:nlat])
    KD = volume(op.kd) if op.kron is not None else 1
    BD = volume(op.bd)
    N = volume(xc.shape[nlat + len(op.kron_d) + len(op.blk_d):])
    xc = _reshape(xc, lat_shape + ((KD, BD, N) if op.kron is not None else (BD, N)))
    col_shape = tuple(int(x.shape[ox.index(c)]) for c in cols)
    return xc, shard, cols, col_shape, user_complex, col_axes


def _local_cols(cols, col_shape, col_axes, mesh):
    """The local extents of the column labels (a sharded one divides
    evenly over its mesh axis)."""
    out = []
    for c, s in zip(cols, col_shape):
        n = axis_size(mesh, col_axes[c]) if c in col_axes else 1
        if s % n:
            raise ValueError(f"column label {c!r} ({s}) must divide evenly over mesh axis "
                             f"{col_axes[c]!r} ({n})")
        out.append(s // n)
    return tuple(out)


def _wrap(op, out, oy: str, shard, mesh, lead: tuple, col_shape, user_complex, extra="",
          col_axes=None):
    """The local result in labels ``oy`` as a DTensor whose image lattice
    labels are sharded as the domain's were, and its column labels as x's
    (a plain tensor where nothing is sharded); ``col_shape`` holds the
    global column extents in oy's order."""
    if user_complex:
        out = cplx.to_complex(out)
    ki = tuple(op.ki) if op.kron is not None else ()
    shape = {c: s for c, s in zip(extra + op.lat_i + op.kron_i + op.blk_i,
                                  lead + tuple(op.dim_i) + ki + tuple(op.bi))}
    canon_cols = [c for c in oy if c not in shape]
    shape.update(dict(zip(canon_cols, col_shape)))
    col_axes = col_axes or {}
    if not shard and not col_axes:
        return out
    axes = {op.lat_i[k]: nm for k, nm in shard.items()}
    axes.update(col_axes)
    return wrap_labels(out, mesh, oy, axes, tuple(shape[c] for c in oy))


def bsr_krylov_ca(
    alpha,
    op: BSROperator,
    x,
    ox: str,
    mesh,
    axes: Dict[str, Optional[str]],
    power: int,
    okr: str = "p",
    oy: Optional[str] = None,
):
    """y_k = alpha * A^{k+1} x for k in [0, power) with ONE halo exchange.

    ``axes`` maps lattice labels to mesh axis names (None/absent =
    unsharded).  ``x`` is a DTensor (or CArray of them) sharded
    accordingly, or a plain tensor every rank holds; the operator's
    blocks are a plain tensor every rank holds or a DTensor sharded the
    same way.  The result carries the power label ``okr`` (like
    ``bsr_krylov`` with ``okr=``, bsr.h:2353) and the same lattice
    sharding.

    Requires a square operator and per-axis halo width
    ``power * max|offset|`` no larger than the local shard extent
    (dist.h:3477-3509)."""
    if op.mode not in ("stencil", "gather"):
        raise ValueError(
            "communication-avoiding powers run on stencil or gather "
            "operators; SoA operators have apply_stencil_soa_sharded")
    if op.dim_i != op.dim_d or volume(op.bi) != volume(op.bd) or (
            op.kron is not None and volume(op.ki) != volume(op.kd)):
        raise ValueError("operator powers require a square operator")
    cols = "".join(c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
    if oy is None:
        oy = op.lat_i + op.kron_i + op.blk_i + cols + okr
    check_order(oy)
    if okr not in oy:
        raise ValueError(f"power label {okr!r} not in oy={oy!r}")
    xc, shard, cols, col_shape, user_complex, col_axes = _prepare(op, x, ox, mesh, axes)
    nlat = len(op.dim_d)

    if op.mode == "gather":
        if shard:
            from .gather_sharded import _gather_local

            stacked = _gather_local(op, xc, mesh, shard, power=power, all_powers=True)
        else:
            fn = _apply_gather_kron if op.kron is not None else _apply_gather
            outs, cur = [], xc
            for _ in range(power):
                cur = fn(op, cur)
                outs.append(cur)
            stacked = _stack(outs, axis=0)
    else:
        radius = [max((abs(o[ax]) for o in op.offsets), default=0) for ax in range(nlat)]
        ax_names: Dict[int, str] = {}
        widths: Dict[int, int] = {}
        for ax, nm in shard.items():
            c = op.lat_d[ax]
            if radius[ax] == 0:
                continue
            if op.dim_d[ax] % axis_size(mesh, nm):
                raise ValueError(
                    f"lattice axis {c!r} ({op.dim_d[ax]}) must divide evenly "
                    f"over mesh axis {nm!r} ({axis_size(mesh, nm)})")
            loc = op.dim_d[ax] // axis_size(mesh, nm)
            w = power * radius[ax]
            if w > loc:
                raise ValueError(
                    f"halo width {w} exceeds local extent {loc} on axis "
                    f"{c!r}; lower power or shard fewer axes")
            ax_names[ax] = nm
            widths[ax] = w
        blocks = local_slab(op.blocks, mesh, shard)
        blocks_e, x_e = _extend([blocks, xc], ax_names, widths, mesh)
        lop = op.replace(blocks=blocks_e, dim=tuple(x_e.shape[:nlat]))
        outs, cur = [], x_e
        for _ in range(power):
            cur = _apply_stencil(lop, cur)
            outs.append(_crop(cur, widths))
        stacked = _stack(outs, axis=0)
    return _finish_powers(op, oy, okr, cols, col_shape, alpha, power, stacked, shard, mesh,
                          user_complex, col_axes)


def _finish_powers(op, oy, okr, cols, col_shape, alpha, power, stacked, shard, mesh,
                   user_complex, col_axes=None):
    """Shared tail: the canonical [power, *lat_loc, KI?, BI, N] stack in
    the user's oy labels, scaled, complex restored, wrapped sharded."""
    lat_loc = tuple(stacked.shape[1:1 + len(op.dim_i)])
    ki_shape = tuple(op.ki) if op.kron is not None else ()
    loc_cols = _local_cols(cols, col_shape, col_axes or {}, mesh)
    shape = (power,) + lat_loc + ki_shape + tuple(op.bi) + loc_cols
    canon_y = okr + op.lat_i + op.kron_i + op.blk_i + cols
    out = local_permute(_reshape(stacked, shape), canon_y, oy)
    if not (_is_static(alpha) and alpha == 1):
        out = cplx.scale(alpha, out)
    col_in_oy = tuple(col_shape[cols.index(c)] for c in oy if c in cols)
    return _wrap(op, out, oy, shard, mesh, (power,), col_in_oy, user_complex, extra=okr,
                 col_axes=col_axes)
