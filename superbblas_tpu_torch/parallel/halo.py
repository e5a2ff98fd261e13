"""Explicit halo exchange over mesh axes (counterpart of
``superbblas_tpu/parallel/halo.py``).

The reference implements halos as partition extension (``ext_power``,
dist.h:3477-3509) plus a general redistribution copy (bsr.h:2189-2192).
Here a halo moves with the same exchange primitive as the redistribution:
``dist.all_to_all_single`` over the mesh axis's group, with nonzero
splits only to the two neighbours (the high edge to the next rank, the
low edge to the previous one).  Every tensor of one call (the parts of a
CArray, a field and its operator's blocks) travels in that one exchange.

``extend_local`` extends a shard-local block by ``width`` sites on each
side of every sharded lattice axis; ``exchange_halos`` does so for a
sharded DTensor and returns the extended blocks as a DTensor;
``post_halos`` starts an exchange asynchronously (``async_op=True``) and
returns a handle whose ``wait()`` gives the halos, for the overlap path.
Each ``extend_local`` call is a ``halo.extend`` span of the tracker
(``utils/tracker.py``, host time), so that a profile ties the packing,
the exchange and the concatenation it launches to this module.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .. import cplx
from ..utils import tracker
from ._local import c_strides
from .mesh import axis_size

__all__ = ["exchange_halos", "crop_halos", "extend_local", "post_halos", "roll_local"]


def _edge(a: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    return a.narrow(axis, lo, hi - lo)


class _Posted:
    """An exchange in flight: ``wait()`` returns, per tensor, the (low,
    high) halo slabs (the previous rank's high edge, the next rank's low
    edge)."""

    def __init__(self, work, send, recv, tensors, axis, width, layout):
        # the send buffer lives until the exchange is waited on
        self.work, self.send, self.recv, self.tensors = work, send, recv, tensors
        self.axis, self.width, self.layout = axis, width, layout

    def wait(self) -> List[tuple]:
        if self.work is not None:
            self.work.wait()
            self.work = self.send = None
        out, recv = [], self.recv
        for t, (lo_off, hi_off) in zip(self.tensors, self.layout):
            shape = list(t.shape)
            shape[self.axis] = self.width
            vol = 1
            for s in shape:
                vol *= s
            out.append((recv[lo_off:lo_off + vol].reshape(shape),
                        recv[hi_off:hi_off + vol].reshape(shape)))
        return out


def post_halos(tensors: Sequence[torch.Tensor], axis: int, name: str, width: int,
               mesh, async_op: bool = False) -> _Posted:
    """Start the exchange of the ``width``-wide edge slabs of ``tensors``
    (shard-local blocks of one dtype) along array ``axis`` over the mesh
    axis ``name``: one ``all_to_all_single`` whose only nonzero splits go
    to the two neighbours (a 1- or 2-rank axis sends both edges to the one
    peer, itself included)."""
    import torch.distributed as dist

    tensors = list(tensors)
    dt = tensors[0].dtype
    if any(t.dtype != dt for t in tensors):
        raise ValueError("post_halos: the tensors of one exchange share a dtype")
    names = tuple(mesh.mesh_dim_names)
    n = int(mesh.mesh.shape[names.index(name)])
    c = mesh.get_local_rank(name)
    nxt, prv = (c + 1) % n, (c - 1) % n
    slab = [t.numel() // t.shape[axis] * width for t in tensors]
    tot = sum(slab)
    # to each peer: [the edges it takes as its low halo | as its high halo];
    # from each peer: [my low halo (its high edge) | my high halo (its low edge)]
    segs, in_splits = [], [0] * n
    for p in range(n):
        if p == nxt:
            segs += [_edge(t, axis, t.shape[axis] - width, t.shape[axis]).reshape(-1)
                     for t in tensors]
            in_splits[p] += tot
        if p == prv:
            segs += [_edge(t, axis, 0, width).reshape(-1) for t in tensors]
            in_splits[p] += tot
    out_splits = [tot * ((p == prv) + (p == nxt)) for p in range(n)]
    send = torch.cat(segs)
    recv = torch.empty(sum(out_splits), dtype=dt, device=send.device)
    work = dist.all_to_all_single(recv, send, out_splits, in_splits,
                                  group=mesh.get_group(name), async_op=async_op)
    base_prv = sum(out_splits[:prv])
    base_nxt = sum(out_splits[:nxt]) + (tot if nxt == prv else 0)
    layout, off = [], 0
    for s in slab:
        layout.append((base_prv + off, base_nxt + off))
        off += s
    return _Posted(work, send, recv, tensors, axis, width, layout)


def _extend_axis(tensors, axis: int, name: str, width: int, mesh):
    got = post_halos(tensors, axis, name, width, mesh).wait()
    return [torch.cat([lo, t, hi], dim=axis) for t, (lo, hi) in zip(tensors, got)]


def _flat(a):
    return list(a) if cplx.is_carray(a) else [a]


@tracker.spanned("halo.extend", events=False)
def extend_local(a, ax_names: Dict[int, str], widths: Dict[int, int], mesh):
    """Halo-extend shard-local (possibly split-complex) blocks along the
    given array axes, one exchange per axis, corners riding the
    sequential per-axis extension.  ``a`` is one block or a list of
    blocks (all extended in the same exchanges); returns the same
    structure."""
    many = isinstance(a, list)
    items = a if many else [a]
    flat = [t for it in items for t in _flat(it)]
    for ax, nm in ax_names.items():
        groups: dict = {}
        for i, t in enumerate(flat):
            groups.setdefault(t.dtype, []).append(i)
        for idx in groups.values():
            ext = _extend_axis([flat[i] for i in idx], ax, nm, widths[ax], mesh)
            for i, e in zip(idx, ext):
                flat[i] = e
    out, k = [], 0
    for it in items:
        if cplx.is_carray(it):
            out.append(cplx.CArray(flat[k], flat[k + 1]))
            k += 2
        else:
            out.append(flat[k])
            k += 1
    return out if many else out[0]


def exchange_halos(x, mesh, spec, widths: Dict[int, int]):
    """Per-shard halo extension of a sharded DTensor (or CArray of them).

    ``spec``: the PartitionSpec of ``x`` over ``mesh``; ``widths``:
    {array axis -> halo width} for sharded axes.  Returns a DTensor with
    the same placements whose sharded axes grew by 2*width*n_shards (each
    shard holds core+halo)."""
    from torch.distributed.tensor import DTensor

    from .mesh import NamedSharding

    names = list(spec)
    ax_names = {ax: names[ax] for ax in widths
                if ax < len(names) and names[ax] is not None}
    parts = _flat(x)
    placements = NamedSharding(mesh, spec).placements()
    loc = extend_local([p.to_local() for p in parts], ax_names, widths, mesh)
    out = []
    for p, e in zip(parts, loc):
        shape = list(p.shape)
        for ax, nm in ax_names.items():
            shape[ax] += 2 * widths[ax] * int(mesh.mesh.shape[
                tuple(mesh.mesh_dim_names).index(nm)])
        out.append(DTensor.from_local(e.contiguous(), mesh, placements,
                                      run_check=False, shape=tuple(shape),
                                      stride=c_strides(shape)))
    return cplx.CArray(*out) if cplx.is_carray(x) else out[0]


def crop_halos(x, widths: Dict[int, int]):
    """Drop the halo shells added by a local extension."""
    def crop(a):
        idx = [slice(None)] * a.ndim
        for ax, w in widths.items():
            idx[ax] = slice(w, a.shape[ax] - w)
        return a[tuple(idx)]
    if cplx.is_carray(x):
        return cplx.cmap(crop, x)
    return crop(x)


def roll_local(a: torch.Tensor, shift: int, axis: int, name, mesh) -> torch.Tensor:
    """This rank's shard of ``torch.roll(global, shift, axis)`` for a
    tensor sharded on ``axis`` over mesh axis ``name`` (None, or a 1-rank
    axis: a local roll): one exchange of the |shift|-wide edges,
    |shift| at most the local extent."""
    if name is None or axis_size(mesh, name) == 1:
        return torch.roll(a, shift, dims=axis)
    w, L = abs(shift), a.shape[axis]
    if w == 0:
        return a
    if w > L:
        raise ValueError(f"a roll by {shift} exceeds the local extent {L}")
    (lo, hi), = post_halos([a], axis, name, w, mesh).wait()
    return torch.cat([lo, a, hi], dim=axis).narrow(axis, w - shift, L)
