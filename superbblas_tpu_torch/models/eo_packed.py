"""Packed checkerboard (even-odd) layout: half-lattice hopping applies and
the even-odd preconditioned solve (counterpart of
``superbblas_tpu/models/eo_packed.py``).

Each parity is stored as a packed half-lattice array, X halved: site
(x, y, z, t) goes to (x // 2, y, z, t).  The hopping term (the centre
direction dropped) is applied directly between packings: a direction
along X reads the unshifted or the shifted packed slot, chosen by the
parity of the image site; every other direction is a plain shift.  Every
matvec of the Schur solve is one such half-lattice apply.  Requires
one-hot +-1 offsets and an even X.

Two layouts: AoS operators (``cb_pack``, ``hopping_packed``,
``apply_hopping_packed``, ``eo_solve_packed``) apply through ``bsr``'s
AoS stencil matvec with the parity-select shift (a no-kron operator,
such as the staggered one, as one batched product on K3/E1); SoA
operators (``*_soa``) through the stencil kernel with ``packed_parity``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cplx
from ..bsr import BSROperator, _apply_stencil, _reshape, apply_stencil_soa
from ..cplx import CArray
from ..labels import volume
from ..ops._guard import is_sharded
from ..ops.stencil import derive_kron
from .even_odd import schur_cg
from .wilson import adjoint_operator

__all__ = ["cb_pack", "cb_unpack", "hopping_packed", "apply_hopping_packed",
           "eo_solve_packed", "cb_pack_soa", "cb_unpack_soa", "hopping_packed_soa",
           "apply_hopping_packed_soa", "eo_solve_packed_soa"]


def _check_one_hot(offsets):
    for off in offsets:
        nz = [o for o in off if o]
        if nz and (len(nz) != 1 or abs(nz[0]) != 1):
            raise ValueError(
                f"packed checkerboarding requires one-hot +-1 stencil "
                f"offsets, got {off}")


def _rest_par_np(rest):
    coords = np.meshgrid(*[np.arange(d) for d in rest], indexing="ij")
    return (sum(coords) % 2) if coords else np.zeros((), np.int64)


def _rest_parity(lat_dims, trailing: int, device, origin: int = 0) -> torch.Tensor:
    """(y + z + t + origin) % 2 (the sum over every lattice axis but the
    first), shaped [1, *rest] + [1]*trailing, on ``device``."""
    rest = tuple(lat_dims[1:])
    rp = (np.asarray(_rest_par_np(rest)) + origin) % 2
    rp = rp.reshape((1,) + rest + (1,) * trailing)
    return torch.from_numpy(np.ascontiguousarray(rp)).to(device)


def _origin_parity(a, x_axis: int, end=None, packed: bool = False) -> int:
    """The parity of (y + z + t) at the first site of this rank's shard of
    the sharded array ``a`` whose lattice axes are ``x_axis`` up to
    ``end`` (X halved where ``packed``); an unpacked shard's X origin must
    be even (a shard holds whole site pairs)."""
    from ..parallel._local import shard_origin

    o = shard_origin(a)
    if o[x_axis] % 2 and not packed:
        raise ValueError(f"packing a shard that starts at the odd x = {o[x_axis]}: shard X "
                         "in an even number of sites a rank")
    return sum(o[x_axis + 1:end]) % 2


def _on_shards(fn, a, axis: int, extent: int, *more):
    """``fn`` on this rank's shards of the sharded ``a`` (and ``more``),
    wrapped back as a DTensor with a's placements and a's global shape but
    ``extent`` on ``axis`` (the axis ``fn`` halves, doubles or selects
    along)."""
    from ..parallel._local import from_local, local

    shape = list((a.re if cplx.is_carray(a) else a).shape)
    shape[axis] = extent
    return from_local(fn(local(a), *(local(m) for m in more)), a, tuple(shape))


def cb_pack(a, nlat: int, parity: int):
    """[X, *rest, ...] -> packed [X/2, *rest, ...] holding the sites with
    (x + sum(rest)) % 2 == parity (``nlat`` leading lattice axes).  A
    sharded ``a`` (DTensors) is packed shard by shard from the parity of
    each shard's global origin."""
    if is_sharded(a):
        x = (a.re if cplx.is_carray(a) else a).shape[0] // 2
        return _on_shards(lambda v: _pack_aos(v, nlat, parity, _origin_parity(a, 0, nlat)),
                          a, 0, x)
    return _pack_aos(a, nlat, parity, 0)


def _pack_aos(a, nlat: int, parity: int, origin: int):
    def pk(v):
        rest_par = _rest_parity(v.shape[:nlat], v.ndim - nlat, v.device, origin)
        # x parity of the kept sites: (parity + rest_par) mod 2
        return torch.where((parity + rest_par) % 2 == 1, v[1::2], v[0::2])
    return cplx.cmap(pk, a) if cplx.is_carray(a) else pk(a)


def cb_unpack(a_even, a_odd, nlat: int):
    """Inverse of :func:`cb_pack` for both parities: the full [X, *rest,
    ...] (sharded as the packings where they are)."""
    if is_sharded(a_even, a_odd):
        x = 2 * (a_even.re if cplx.is_carray(a_even) else a_even).shape[0]
        return _on_shards(lambda e, o: _unpack_aos(e, o, nlat, _origin_parity(
            a_even, 0, nlat, packed=True)), a_even, 0, x, a_odd)
    return _unpack_aos(a_even, a_odd, nlat, 0)


def _unpack_aos(a_even, a_odd, nlat: int, origin: int):
    def up(ae, ao):
        rest_par = _rest_parity((2 * ae.shape[0],) + tuple(ae.shape[1:nlat]),
                                ae.ndim - nlat, ae.device, origin)
        ev = torch.where(rest_par == 1, ao, ae)     # the even-x slots
        od = torch.where(rest_par == 0, ao, ae)     # the odd-x slots
        return torch.stack([ev, od], dim=1).reshape((2 * ae.shape[0],) + tuple(ae.shape[1:]))
    if cplx.is_carray(a_even):
        return CArray(up(a_even.re, a_odd.re), up(a_even.im, a_odd.im))
    return up(a_even, a_odd)


def hopping_packed(op: BSROperator, to_parity: int) -> BSROperator:
    """The AoS hopping operator (centre dropped) packed onto ``to_parity``
    image sites: blocks [X/2, *rest, ndir-1, BI, BD] on the half lattice
    (both ``dim_i`` and ``dim_d``); its apply is
    :func:`apply_hopping_packed`."""
    if op.mode != "stencil":
        raise ValueError("packed checkerboarding needs an AoS stencil op")
    if op.dim_d[0] % 2:
        raise ValueError("X extent must be even")
    _check_one_hot(op.offsets)
    nlat = len(op.dim_d)
    keep = [k for k, off in enumerate(op.offsets) if any(off)]
    kidx = torch.tensor(keep, device=op.blocks_re.device)

    def sel(v):
        return cplx.cmap(lambda b: b.index_select(nlat, kidx), v) if cplx.is_carray(v) \
            else v.index_select(nlat, kidx)

    sharded = is_sharded(op.blocks_re)
    blocks = cb_pack(_on_shards(sel, op.blocks, nlat, len(keep)) if sharded
                     else sel(op.blocks), nlat, to_parity)
    kron = op.kron
    if kron is not None:
        kron = cplx.cmap(lambda v: v[kidx], kron) if cplx.is_carray(kron) else kron[kidx]
    dim = (op.dim_d[0] // 2,) + tuple(op.dim_d[1:])
    return op.replace(blocks=blocks, kron=kron, offsets=tuple(op.offsets[k] for k in keep),
                      dim=dim)


def apply_hopping_packed(hop: BSROperator, x_from, to_parity: int):
    """y_to = H x_from between AoS packings (``x_from`` holds the opposite
    parity), on the canonical operand [X/2, *rest, KD?, BD, N]: the AoS
    stencil matvec with a parity-select X shift (a +x neighbour is the
    next packed slot where the image site's x is odd, else the same slot;
    a -x neighbour the same slot where it is odd, else the one before),
    every other direction a plain roll."""
    if is_sharded(x_from, hop.blocks_re):
        return _hopping_packed_sharded(hop, x_from, to_parity)
    return _apply_packed(hop, x_from, to_parity, 0)


def _hopping_packed_sharded(hop: BSROperator, x_from, to_parity: int):
    """:func:`apply_hopping_packed` on a sharded packed operand (DTensors,
    lattice and column labels sharded): x's shard extended by one site a
    side on each sharded lattice axis (one exchange an axis), the
    parity-select shifts run on the extended block from the parity of its
    global origin, the core kept; the blocks are the rank's slab."""
    from ..parallel._local import from_local, local, local_slab, mesh_axes, shard_origin
    from ..parallel.halo import extend_local
    from ..parallel.mesh import axis_size

    nlat = len(hop.dim_d)
    x = x_from.re if cplx.is_carray(x_from) else x_from
    labels = "".join(chr(0x100 + i) for i in range(x.ndim))
    mesh, lab = mesh_axes(x_from, labels)
    ax_names = {labels.index(c): nm for c, nm in lab.items()
                if labels.index(c) < nlat and axis_size(mesh, nm) > 1}
    widths = {ax: 1 for ax in ax_names}
    origin = shard_origin(x_from)
    xe = extend_local(local(x_from), ax_names, widths, mesh)
    lop = hop.replace(blocks=local_slab(hop.blocks, mesh, ax_names),
                      dim=tuple(local(x).shape[:nlat]))
    y = _apply_packed(lop, xe, to_parity, sum(origin[1:nlat]) - sum(
        w for ax, w in widths.items() if ax > 0), crop=widths)
    return from_local(y, x_from)


def _apply_packed(hop: BSROperator, x_from, to_parity: int, origin: int, crop=None):
    """The packed hopping on the block ``x_from`` whose first site's
    (y + z + t) has the parity of ``origin``; with ``crop`` ({axis:
    width}), ``x_from`` carries halo shells of those widths, which each
    shifted operand drops."""
    from ..parallel.halo import crop_halos

    nlat = len(hop.dim_d)
    sample = x_from.re if cplx.is_carray(x_from) else x_from
    lat_ext = tuple(sample.shape[:nlat])
    rest_par = _rest_parity(lat_ext, sample.ndim - nlat, sample.device, origin)
    # x parity of the IMAGE site: (to_parity + rest_par) % 2
    img_x_odd = (to_parity + rest_par) % 2 == 1
    x_core = x_from if not crop else crop_halos(x_from, crop)

    def shift(v, off, nl):
        def sh(a):
            ax = next(i for i, o in enumerate(off) if o)
            s = off[ax]
            if ax == 0:
                if s > 0:
                    # neighbour xh' = xh + [image x odd]
                    return torch.where(img_x_odd, torch.roll(a, -1, dims=0), a)
                # neighbour xh' = xh - [image x even]
                return torch.where(img_x_odd, a, torch.roll(a, 1, dims=0))
            return torch.roll(a, -s, dims=ax)
        src = v if not crop else x_from
        out = cplx.cmap(sh, src) if cplx.is_carray(src) else sh(src)
        return out if not crop else crop_halos(out, crop)

    return _apply_stencil(hop, x_core, shift=shift)


def eo_solve_packed(op: BSROperator, b, a: float, n_iters: int = 50):
    """Even-odd preconditioned solve with packed half-lattice AoS arrays
    (the matvecs run on X/2 arrays, no masked waste); the contract of
    :func:`superbblas_tpu_torch.models.even_odd.eo_solve`: ``b`` [*lat,
    ...] whose trailing axes hold (KD,) BD and the columns, a CArray or a
    tensor (a complex one is solved split and returned complex).  Returns
    (psi shaped as ``b``, |r_e|^2 of the Schur CG)."""
    if not cplx.is_carray(b) and b.is_complex():
        psi, rs = eo_solve_packed(op, cplx.from_complex(b), a, n_iters)
        return cplx.to_complex(psi), rs
    nlat = len(op.dim_d)
    cols_shape = tuple((b.re if cplx.is_carray(b) else b).shape[nlat:])
    kron = op.kron_re is not None
    KD = volume(op.kd) if kron else 1
    BD = volume(op.bd)
    N = volume(cols_shape) // (KD * BD)
    bc = _reshape(b, tuple(op.dim_d) + ((KD, BD, N) if kron else (BD, N)))
    b_e = cb_pack(bc, nlat, 0)
    b_o = cb_pack(bc, nlat, 1)

    hop_e = hopping_packed(op, 0)          # -> even
    hop_o = hopping_packed(op, 1)          # -> odd
    op_h = adjoint_operator(op)
    hop_e_h = hopping_packed(op_h, 0)
    hop_o_h = hopping_packed(op_h, 1)
    del op_h

    def Dhat(v_e):
        t_o = apply_hopping_packed(hop_o, v_e, 1)
        t_e = apply_hopping_packed(hop_e, t_o, 0)
        return cplx.add(cplx.scale(a, v_e), cplx.scale(-1.0 / a, t_e))

    def Dhat_h(v_e):
        t_o = apply_hopping_packed(hop_o_h, v_e, 1)
        t_e = apply_hopping_packed(hop_e_h, t_o, 0)
        return cplx.add(cplx.scale(a, v_e), cplx.scale(-1.0 / a, t_e))

    rhs = cplx.add(b_e, cplx.scale(-1.0 / a, apply_hopping_packed(hop_e, b_o, 0)))
    psi_e, rs = schur_cg(Dhat, Dhat_h, rhs, n_iters)
    psi_o = cplx.scale(1.0 / a, cplx.add(
        b_o, cplx.scale(-1.0, apply_hopping_packed(hop_o, psi_e, 1))))
    full = cb_unpack(psi_e, psi_o, nlat)
    return _reshape(full, tuple(op.dim_d) + cols_shape), rs


# ---------------------------------------------------------------------------
# SoA (stencil kernel) packed checkerboarding
# ---------------------------------------------------------------------------


def _rest_par(rest, device, origin: int = 0) -> torch.Tensor:
    """(y + z + t + origin) % 2, shaped [1, 1, 1, *rest], on ``device``."""
    rp = (_rest_par_np(rest) + origin) % 2
    rp = rp.reshape((1, 1, 1) + tuple(rest))
    return torch.from_numpy(np.ascontiguousarray(rp)).to(device)


def cb_pack_soa(a: CArray, parity: int) -> CArray:
    """SoA layout [n|ndir, F, X, *rest]: keep the sites with
    (x + sum(rest)) % 2 == parity, halving X (array axis 2).  The parts
    keep their dtype.  A sharded ``a`` (DTensors) is packed shard by
    shard from the parity of each shard's global origin."""
    if is_sharded(a):
        return _on_shards(lambda v: _pack_soa(v, parity, _origin_parity(a, 2)), a, 2,
                          a.re.shape[2] // 2)
    return _pack_soa(a, parity, 0)


def _pack_soa(a, parity: int, origin: int):
    def pk(v):
        rp = _rest_par(v.shape[3:], v.device, origin)
        ev, od = v[:, :, 0::2], v[:, :, 1::2]
        return torch.where((parity + rp) % 2 == 1, od, ev)
    return cplx.cmap(pk, a)


def cb_unpack_soa(a_even: CArray, a_odd: CArray) -> CArray:
    """Inverse of :func:`cb_pack_soa` for both parities: the full
    [n|ndir, F, 2 X/2, *rest] (sharded as the packings where they are)."""
    if is_sharded(a_even, a_odd):
        return _on_shards(lambda e, o: _unpack_soa(e, o, _origin_parity(a_even, 2, packed=True)),
                          a_even, 2, 2 * a_even.re.shape[2], a_odd)
    return _unpack_soa(a_even, a_odd, 0)


def _unpack_soa(a_even, a_odd, origin: int):
    def up(e, o):
        rest = tuple(e.shape[3:])
        rp = _rest_par(rest, e.device, origin)
        ev = torch.where(rp == 1, o, e)
        od = torch.where(rp == 0, o, e)
        out = torch.stack([ev, od], dim=3)
        return out.reshape(tuple(e.shape[:2]) + (2 * e.shape[2],) + rest)
    return CArray(up(a_even.re, a_odd.re), up(a_even.im, a_odd.im))


def hopping_packed_soa(op: BSROperator, to_parity: int) -> BSROperator:
    """The SoA hopping operator (centre dropped) packed onto ``to_parity``
    image sites, on the half lattice; its matvec is the stencil kernel
    with ``packed_parity=to_parity``.  Blocks keep their storage dtype."""
    if op.mode != "stencil_soa":
        raise ValueError("needs an SoA-layout stencil operator")
    if op.dim_d[0] % 2:
        raise ValueError("X extent must be even")
    _check_one_hot(op.offsets)
    keep = [k for k, off in enumerate(op.offsets) if any(off)]
    kidx = torch.tensor(keep, device=op.blocks_re.device)
    sel = cplx.cmap(lambda v: v[kidx], op.blocks) if not is_sharded(op.blocks_re) else \
        _on_shards(lambda v: cplx.cmap(lambda b: b[kidx], v), op.blocks, 0, len(keep))
    blocks = cb_pack_soa(sel, to_parity)
    kron = op.kron
    if kron is not None:
        kron = cplx.cmap(lambda v: v[kidx], kron)
        derive_kron(op.kron, kron, lambda re, im: (re[keep], im[keep]))
    dim = (op.dim_d[0] // 2,) + tuple(op.dim_d[1:])
    return op.replace(blocks=blocks, kron=kron,
                      offsets=tuple(op.offsets[k] for k in keep), dim=dim)


def apply_hopping_packed_soa(hop: BSROperator, x_from: CArray,
                             to_parity: int, interpret=None) -> CArray:
    """y_to = H x_from between SoA packings (``x_from`` holds the opposite
    parity): the stencil kernel for CUDA operands, its plain version for
    CPU ones.  ``interpret`` is accepted and unused."""
    return apply_stencil_soa(hop, x_from, packed_parity=to_parity)


def eo_solve_packed_soa(op: BSROperator, b_soa: CArray, a: float,
                        n_iters: int = 50):
    """Even-odd preconditioned solve of D psi = b on packed half lattices.

    ``op``: SoA-layout operator whose centre direction is ``a`` times the
    identity (``a`` = mass + 4 r for Wilson); ``b_soa``: [n, KD*BD, X,
    *rest].  CG on the normal equations of the Schur complement
    Dhat = a - (1/a) H_eo H_oe for ``n_iters`` iterations; each Dhat or
    Dhat^H is two packed hopping applies, 4 n_iters + 4 in all.  Returns
    (psi in the SoA layout, |r|^2 of the Schur CG)."""
    if op.mode != "stencil_soa":
        raise ValueError("needs an SoA-layout operator")
    b_e = cb_pack_soa(b_soa, 0)
    b_o = cb_pack_soa(b_soa, 1)

    hop_e = hopping_packed_soa(op, 0)
    hop_o = hopping_packed_soa(op, 1)
    op_h = adjoint_operator(op)
    hop_e_h = hopping_packed_soa(op_h, 0)
    hop_o_h = hopping_packed_soa(op_h, 1)
    del op_h

    def Dhat(v_e):
        t_o = apply_hopping_packed_soa(hop_o, v_e, 1)
        t_e = apply_hopping_packed_soa(hop_e, t_o, 0)
        return cplx.add(cplx.scale(a, v_e), cplx.scale(-1.0 / a, t_e))

    def Dhat_h(v_e):
        t_o = apply_hopping_packed_soa(hop_o_h, v_e, 1)
        t_e = apply_hopping_packed_soa(hop_e_h, t_o, 0)
        return cplx.add(cplx.scale(a, v_e), cplx.scale(-1.0 / a, t_e))

    rhs = cplx.add(b_e, cplx.scale(
        -1.0 / a, apply_hopping_packed_soa(hop_e, b_o, 0)))

    psi_e, rs = schur_cg(Dhat, Dhat_h, rhs, n_iters)
    psi_o = cplx.scale(1.0 / a, cplx.add(
        b_o, cplx.scale(-1.0, apply_hopping_packed_soa(hop_o, psi_e, 1))))
    return cb_unpack_soa(psi_e, psi_o), rs
