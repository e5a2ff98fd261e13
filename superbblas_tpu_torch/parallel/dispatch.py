"""The ordinary entry points on sharded operands.

The JAX package computes on sharded ``jax.Array``s through its ordinary
functions.  Here ``bsr.apply_stencil_soa``, ``bsr.bsr_krylov``,
``ops.copy.local_copy``/``local_permute`` and
``ops.contract.local_contraction`` send DTensor operands (or CArrays of
them) to this module, which reads their placements into the
``(mesh, {label: mesh axis})`` form the ``parallel`` functions take and
calls the one that runs the kernel on each rank's local shard:

  * SoA stencil: ``apply_stencil_soa_sharded`` (K1 on the halo-extended
    block);
  * AoS stencil: ``bsr_krylov_overlap`` (the core/halo split, K3 in the
    no-kron mode); with ``okr``, ``bsr_krylov_ca``;
  * gather mode: the halo plan of ``gather_sharded`` (K3/E1), and
    ``bsr_krylov_ca`` with ``okr``;
  * copies: ``parallel.copy``; contractions: ``parallel.contraction``;
    a permutation relabels each shard and its placements (no exchange).

Sharded column labels need no exchange.  Nothing gathers a whole
operand: an operand no sharded implementation takes raises, naming the
``parallel`` function.
"""

from __future__ import annotations

from .. import cplx
from ..labels import check_order, volume
from ..ops.copy import _is_static, local_permute
from ._local import c_strides, dtensor_of, lattice_shards, local, mesh_axes

__all__ = ["apply_stencil_soa_dtensor", "bsr_krylov_dtensor", "local_permute_dtensor"]


def apply_stencil_soa_dtensor(op, x, packed_parity=None):
    """``bsr.apply_stencil_soa`` on a sharded SoA field [n, KD*BD, *lat]:
    ``apply_stencil_soa_sharded`` over x's mesh, its lattice and column
    shards read from x's placements."""
    from .stencil_sharded import apply_stencil_soa_sharded

    mesh, lat, _ = lattice_shards(op, x, "nf" + op.lat_d, "apply_stencil_soa")
    return apply_stencil_soa_sharded(op, x, mesh, lat, packed_parity=packed_parity)


def _add_beta_y(out, beta, y):
    if y is None or (_is_static(beta) and beta == 0):
        return out
    return cplx.add(out, cplx.scale(beta, y))


def bsr_krylov_dtensor(alpha, op, x, ox, beta, y, oy, okr, power):
    """``bsr.bsr_krylov`` on sharded operands (its arguments, with x or
    the blocks DTensors)."""
    from .overlap import _finish_overlap, bsr_krylov_overlap
    from .powers import _prepare, bsr_krylov_ca

    check_order(ox)
    user_complex = dtensor_of(x) is not None and not cplx.is_carray(x) and x.is_complex()
    mesh, lat, cols = lattice_shards(op, x, ox, "bsr_krylov")
    if okr is not None:
        if y is not None:
            power = y.shape[oy.index(okr)]
        if op.mode == "stencil_soa":
            raise ValueError("bsr_krylov: powers (okr) of a sharded SoA operator: use "
                             "parallel.apply_stencil_soa_sharded(..., power=)")
        out = bsr_krylov_ca(alpha, op, x, ox, mesh, lat, power, okr=okr, oy=oy)
        return _add_beta_y(out, beta, y)
    if op.mode == "stencil":
        return bsr_krylov_overlap(alpha, op, x, ox, mesh, lat, beta=beta, y=y, oy=oy)
    if op.mode == "gather":
        from .gather_sharded import _gather_local

        if oy is None:
            oy = op.lat_i + op.kron_i + op.blk_i + "".join(
                c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
        xc, shard, cs, col_shape, uc, col_axes = _prepare(op, x, ox, mesh, lat)
        yc = _gather_local(op, xc, mesh, shard)
        return _finish_overlap(op, oy, cs, col_shape, alpha, beta, y, yc, shard, mesh, uc,
                               col_axes)
    return _soa_krylov(alpha, op, x, ox, beta, y, oy, mesh, lat, cols, user_complex)


def _soa_krylov(alpha, op, x, ox, beta, y, oy, mesh, lat, col_axes, user_complex):
    """An SoA operator through ``bsr_krylov`` on a sharded field: the
    local shard in the SoA order, K1 on the halo-extended block
    (``stencil_sharded._soa_local``), the result in ``oy``."""
    from .powers import _local_cols, _wrap
    from .stencil_sharded import _soa_local

    xl = local(x)
    if user_complex:
        xl = cplx.from_complex(xl)
    xl = xl if cplx.is_carray(xl) else cplx.CArray(xl, xl.new_zeros(xl.shape))
    cols = "".join(c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
    col_shape = tuple(int(x.shape[ox.index(c)]) for c in cols)
    loc_cols = _local_cols(cols, col_shape, col_axes, mesh)
    kron = op.kron_re is not None
    KD = volume(op.kd) if kron else 1
    BD = volume(op.bd)
    soa_x = cols + op.kron_d + op.blk_d + op.lat_d
    xs = local_permute(xl, ox, soa_x)
    lat_loc = tuple(xs.re.shape[len(cols) + len(op.kron_d) + len(op.blk_d):])
    xs = cplx.cmap(lambda a: a.reshape((volume(loc_cols), KD * BD) + lat_loc), xs)
    ys = _soa_local(op, xs, mesh, lat)
    ki_shape = tuple(op.ki) if kron else ()
    ys = cplx.cmap(lambda a: a.reshape(loc_cols + ki_shape + tuple(op.bi) + lat_loc), ys)
    if oy is None:
        oy = op.lat_i + op.kron_i + op.blk_i + cols
    out = local_permute(ys, cols + op.kron_i + op.blk_i + op.lat_i, oy)
    if not (_is_static(alpha) and alpha == 1):
        out = cplx.scale(alpha, out)
    if y is not None and not (_is_static(beta) and beta == 0):
        yl = local(y)
        if user_complex and not cplx.is_carray(yl):
            yl = cplx.from_complex(yl)
        out = cplx.add(out, cplx.scale(beta, yl))
    shard = {k: lat[c] for k, c in enumerate(op.lat_d) if c in lat}
    col_in_oy = tuple(col_shape[cols.index(c)] for c in oy if c in cols)
    return _wrap(op, out, oy, shard, mesh, (), col_in_oy, user_complex, col_axes=col_axes)


def local_permute_dtensor(x, o0: str, o1: str, dtype=None):
    """``ops.copy.local_permute`` of a DTensor (or CArray of them): each
    shard is permuted and the placements follow their labels, so nothing
    moves between ranks.  A size-1 label dropped from ``o1`` must not be
    sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, lab = mesh_axes(x, o0)
    gone = [c for c in lab if c not in o1]
    if gone:
        raise ValueError(f"local_permute: labels {gone} are sharded and absent from {o1!r}")
    d = dtensor_of(x)
    dims = dict(zip(o0, d.shape))
    shape = tuple(int(dims.get(c, 1)) for c in o1)
    pl = []
    for nm in mesh.mesh_dim_names:
        labs = [c for c, m in lab.items() if m == nm]
        pl.append(Shard(o1.index(labs[0])) if labs else Replicate())
    loc = local_permute(local(x), o0, o1, dtype)

    def wrap(a):
        return DTensor.from_local(a.contiguous(), mesh, pl, run_check=False, shape=shape,
                                  stride=c_strides(shape))

    return cplx.cmap(wrap, loc) if cplx.is_carray(loc) else wrap(loc)

