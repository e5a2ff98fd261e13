"""Shard-local views of DTensors (and CArrays of them) and the way back,
shared by the distributed layer's modules."""

from __future__ import annotations

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
