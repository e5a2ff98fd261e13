"""Shard-local views of DTensors (and CArrays of them) and the way back,
shared by the distributed layer's modules."""

from __future__ import annotations

import sys

import torch

from .. import cplx


def local(t):
    """This rank's shard of a DTensor or a CArray of them (the tensor
    itself otherwise).  A replicated operand (a kron factor) keeps its
    local tensor's identity, so the per-tensor caches it keys stay hit."""
    from torch.distributed.tensor import DTensor

    if t is None:
        return None
    if cplx.is_carray(t):
        return cplx.CArray(local(t.re), local(t.im))
    return t._local_tensor if isinstance(t, DTensor) else t


def c_strides(shape):
    st, acc = [], 1
    for s in reversed(tuple(shape)):
        st.append(acc)
        acc *= int(s)
    return tuple(reversed(st))


def from_local(loc, like, shape=None):
    """A DTensor (or CArray of them) with ``like``'s mesh and placements
    around the local shard(s) ``loc``, of global ``shape`` (``like``'s
    where None)."""
    from torch.distributed.tensor import DTensor

    ref = like.re if cplx.is_carray(like) else like
    shape = tuple(ref.shape) if shape is None else tuple(int(s) for s in shape)

    def wrap(a):
        return DTensor.from_local(a.contiguous(), ref.device_mesh, ref.placements,
                                  run_check=False, shape=shape, stride=c_strides(shape))

    return cplx.cmap(wrap, loc) if cplx.is_carray(loc) else wrap(loc)


def label_axes(x, o: str) -> dict:
    """{label: mesh axis name} of the labels of ``o`` that the DTensor
    ``x`` (or CArray of them) shards; {} for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard

    a = x.re if cplx.is_carray(x) else x
    if not isinstance(a, DTensor):
        return {}
    return {o[p.dim]: nm for nm, p in zip(a.device_mesh.mesh_dim_names, a.placements)
            if isinstance(p, Shard)}


def local_slab(t, mesh, ax_names: dict):
    """This rank's slab of ``t`` along the array axes ``ax_names`` (axis
    -> mesh axis name): a DTensor's local shard, or the even chunk of a
    plain tensor every rank holds (an operator's replicated blocks)."""
    from torch.distributed.tensor import DTensor

    if t is None:
        return None
    if cplx.is_carray(t):
        return cplx.CArray(local_slab(t.re, mesh, ax_names), local_slab(t.im, mesh, ax_names))
    if isinstance(t, DTensor):
        return t._local_tensor
    names = tuple(mesh.mesh_dim_names)
    for ax, nm in ax_names.items():
        n = int(mesh.mesh.shape[names.index(nm)])
        L = t.shape[ax] // n
        t = t.narrow(ax, mesh.get_local_rank(nm) * L, L)
    return t


def wrap_labels(loc, mesh, o: str, axes: dict, shape):
    """A DTensor (or CArray of them) over ``mesh`` from local shards with
    labels ``o``, label ``c`` sharded over mesh axis ``axes[c]``, of
    global ``shape``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = []
    for nm in mesh.mesh_dim_names:
        labs = [c for c, m in axes.items() if m == nm and c in o]
        pl.append(Shard(o.index(labs[0])) if labs else Replicate())
    shape = tuple(int(s) for s in shape)

    def wrap(a):
        return DTensor.from_local(a.contiguous(), mesh, pl, run_check=False, shape=shape,
                                  stride=c_strides(shape))

    return cplx.cmap(wrap, loc) if cplx.is_carray(loc) else wrap(loc)


def dtensor_of(t):
    """The DTensor behind ``t`` (a DTensor or a CArray of them), or None
    for a plain tensor (a CArray whose parts disagree raises)."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None or t is None:
        return None
    if cplx.is_carray(t):
        a, b = isinstance(t.re, mod.DTensor), isinstance(t.im, mod.DTensor)
        if a != b:
            raise ValueError("a CArray with one sharded part and one plain part")
        return t.re if a else None
    return t if isinstance(t, mod.DTensor) else None


def mesh_axes(t, o: str):
    """``(mesh, {label: mesh axis})`` of the DTensor ``t`` (or CArray of
    them) with labels ``o``: its placements read as the ``parallel``
    functions take them; ``(None, {})`` for a plain tensor.  A label
    sharded over two mesh axes, or a partial placement, raises."""
    from torch.distributed.tensor import Replicate, Shard

    d = dtensor_of(t)
    if d is None:
        return None, {}
    if d.ndim != len(o):
        raise ValueError(f"a rank-{d.ndim} DTensor with labels {o!r}")
    out = {}
    for nm, p in zip(d.device_mesh.mesh_dim_names, d.placements):
        if isinstance(p, Shard):
            c = o[p.dim]
            if c in out:
                raise ValueError(f"label {c!r} is sharded over two mesh axes "
                                 f"({out[c]!r}, {nm!r}); the sharded entry points take one")
            out[c] = nm
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} has no partition (reduce it first)")
    return d.device_mesh, out


def shard_origin(t) -> tuple:
    """Global offset of this rank's shard of the DTensor ``t`` (or CArray
    of them), per array axis; zeros for a plain tensor."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    d = dtensor_of(t)
    if d is None:
        a = t.re if cplx.is_carray(t) else t
        return (0,) * a.ndim
    return tuple(int(v) for v in compute_local_shape_and_global_offset(
        d.shape, d.device_mesh, d.placements)[1])


def lattice_shards(op, x, ox: str, what: str):
    """(mesh, {lattice label: mesh axis}, {other label: mesh axis}) of a
    sharded operand ``x`` (labels ``ox``) of the operator ``op``; ``op``'s
    blocks, where they are DTensors, must live on x's mesh and shard the
    lattice as x does.  Only lattice and column labels may be sharded."""
    mesh, lab = mesh_axes(x, ox)
    if mesh is None:
        raise ValueError(f"{what}: the blocks are sharded but the field is not; shard "
                         "the field as the blocks")
    fixed = op.kron_d + op.blk_d
    bad = [c for c in lab if c in fixed]
    if bad:
        raise ValueError(f"{what}: labels {bad} (spin or block) are sharded; only lattice "
                         "and column labels may be")
    lat = {c: nm for c, nm in lab.items() if c in op.lat_d}
    cols = {c: nm for c, nm in lab.items() if c not in op.lat_d}
    blk = dtensor_of(op.blocks_re if op.blocks_im is None else
                     cplx.CArray(op.blocks_re, op.blocks_im))
    if blk is not None and op.mode == "gather":
        raise ValueError(f"{what}: gather-mode blocks are stored flat; keep them whole on "
                         "every rank (each rank takes its rows)")
    if blk is not None:
        if blk.device_mesh != mesh:
            raise ValueError(f"{what}: the blocks and the field live on different meshes")
        nlat = len(op.dim_i)
        lead = 2 if op.mode == "stencil_soa" else 0
        names = [chr(0x100 + i) for i in range(blk.ndim)]
        for k in range(nlat):
            names[lead + k] = op.lat_d[k]
        _, blab = mesh_axes(blk, "".join(names))
        for c in set(blab) | set(lat):
            if blab.get(c) != lat.get(c):
                raise ValueError(
                    f"{what}: the blocks shard lattice label {c!r} over {blab.get(c)!r} "
                    f"and the field over {lat.get(c)!r}; they must agree")
    return mesh, lat, cols
