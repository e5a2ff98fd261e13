"""Distributed copy / contraction / reshard on DTensors (counterpart of
``superbblas_tpu/parallel/dist.py``).

The reference's distribution layer (dist.h:2264-3245) plans box
intersections, packs fragments and exchanges them with MPI_Ialltoallv.
Here:

  * ``copy`` runs on each rank's local shards where the boxes are
    shard-local, and otherwise moves the copied box through the
    redistribution plan (redistribute.py) from ``x``'s sharding to
    ``y``'s — the reference library's own copy path (dist.h:3534) —
    then writes it into ``y``'s local shard with ``alpha`` and
    ``copy_add``.  A masked copy (compaction pairing, tensor.h:1021-1030)
    moves the paired elements with the same exchange primitive.
  * ``contraction`` contracts the local shards (``local_contraction``),
    after resharding an operand where the two disagree on a label's mesh
    axis, all-reduces over the mesh axes that shard a contracted label,
    and returns the result with the requested ``out_sharding``
    (dist.h:3039-3196).
  * ``reshard`` is ``DTensor.redistribute`` on one mesh, the plan across
    meshes.

At SBT_DEBUG>=2 every distributed copy is replayed with a mock-index
verifier (utils/testing.py), as the JAX package does.
"""

from __future__ import annotations

import itertools
import numpy as np
import torch

from .. import cplx, flags
from ..labels import check_isomorphic, find_permutation, volume
from ..ops.contract import local_contraction
from ..ops.copy import _box_flat_indices, _is_static, local_copy
from ..utils.tracker import tracked as _tracked
from ._local import c_strides, from_local, local
from .partition import Partition

__all__ = ["copy", "contraction", "reshard"]


def _dt(x):
    from torch.distributed.tensor import DTensor

    a = x.re if cplx.is_carray(x) else x
    return a if isinstance(a, DTensor) else None


def _boxes(x, shape):
    """Per-rank (from, size) boxes of ``x`` (every rank the full box for
    a plain tensor every rank holds)."""
    from .mesh import sharding_partition

    d = _dt(x)
    if d is None:
        import torch.distributed as dist

        n = dist.get_world_size()
        return [((0,) * len(shape), tuple(shape))] * n
    return list(sharding_partition(d, shape).boxes)


def _cut_region(from0, size0, dim0, from1, dim1, amap):
    """Sub-boxes of the copy region (offset, shape in o0 order) that wrap
    neither in x's lattice nor in y's (``amap[a]`` = y axis of x axis a)."""
    per_axis = []
    for a, (f, s, d) in enumerate(zip(from0, size0, dim0)):
        cuts = {0, s}
        for base, dd in ((f, d), (from1[amap[a]], dim1[amap[a]])):
            c = (dd - base % dd) % dd
            while c < s:
                if c > 0:
                    cuts.add(c)
                c += dd
        cs = sorted(cuts)
        per_axis.append([(p0, p1 - p0) for p0, p1 in zip(cs[:-1], cs[1:])])
    for combo in itertools.product(*per_axis):
        yield tuple(c[0] for c in combo), tuple(c[1] for c in combo)


def _clip(box, lo, size):
    """(from relative to lo, size) of box ∩ [lo, lo+size) — both
    non-wrapping — or an empty box."""
    frm, sz = [], []
    for (bf, bs), l, s in zip(zip(*box), lo, size):
        a, b = max(bf, l), min(bf + bs, l + s)
        if b <= a:
            return (0,) * len(lo), (0,) * len(lo)
        frm.append(a - l)
        sz.append(b - a)
    return tuple(frm), tuple(sz)


def _write(yl, frm, piece, alpha, copy_add):
    sl = tuple(slice(f, f + s) for f, s in zip(frm, piece.shape))
    piece = piece if _is_static(alpha) and alpha == 1 else piece * alpha
    piece = piece.to(yl.dtype)
    if copy_add == "copy":
        yl[sl] = piece
    else:
        yl[sl] += piece


def _copy_parts(alpha, xl, x_plain, o0, yl, o1, from0, size0, from1, copy_add, x_boxes,
                y_boxes, dim0, dim1):
    """Unmasked distributed copy of one real part (``xl``, ``yl``: this
    rank's shards, or the whole tensor every rank holds where ``x_plain``;
    ``o0`` and ``o1`` hold the same labels): returns y's new local shard."""
    from torch.distributed.tensor import DTensor, Shard

    from .redistribute import _axis_mesh, redistribute_explicit

    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    yl = yl.clone()
    amap = [o1.index(c) for c in o0]
    perm = find_permutation(o0, o1)
    for off, sh in _cut_region(from0, size0, dim0, from1, dim1, amap):
        xlo = tuple((f + o) % d for f, o, d in zip(from0, off, dim0))
        ylo, ysh = [0] * len(o1), [0] * len(o1)
        for a, b in enumerate(amap):
            ylo[b] = (from1[b] + off[a]) % dim1[b]
            ysh[b] = sh[a]
        dst = Partition(dim=tuple(ysh), boxes=tuple(_clip(b, ylo, ysh) for b in y_boxes))
        dfrm, dsz = dst.boxes[r]
        yoff = tuple(f + lo - bf for f, lo, bf in zip(dfrm, ylo, y_boxes[r][0]))
        if x_plain:
            # every rank holds x: take this rank's piece locally
            if volume(dsz):
                sl = [None] * len(o0)
                for a, b in enumerate(amap):
                    sl[a] = slice(xlo[a] + dfrm[b], xlo[a] + dfrm[b] + dsz[b])
                _write(yl, yoff, xl[tuple(sl)].permute(perm), alpha, copy_add)
            continue
        src = Partition(dim=tuple(sh), boxes=tuple(_clip(b, xlo, sh) for b in x_boxes))
        sfrm, ssz = src.boxes[r]
        shape = tuple(max(b[1][i] for b in src.boxes) for i in range(len(sh)))
        blk = torch.zeros(shape, dtype=xl.dtype, device=xl.device)
        if volume(ssz):
            xo = tuple(f + lo - bf for f, lo, bf in zip(sfrm, xlo, x_boxes[r][0]))
            blk[tuple(slice(0, s) for s in ssz)] = xl[tuple(slice(f, f + s)
                                                         for f, s in zip(xo, ssz))]
        dm = _axis_mesh(None, "p", n, xl.device.type)
        st = DTensor.from_local(blk[None], dm, [Shard(0)], run_check=False,
                                shape=(n,) + shape, stride=c_strides((n,) + shape))
        got = redistribute_explicit(st, src, dst, dm,
                                    perm=None if perm == tuple(range(len(o0))) else perm)
        if volume(dsz):
            _write(yl, yoff, got.to_local()[0][tuple(slice(0, s) for s in dsz)], alpha,
                   copy_add)
    return yl


def _masked_parts(alpha, xl, o0, yl, o1, from0, size0, from1, copy_add, x_boxes, y_boxes,
                  dim0, dim1, mask0, mask1):
    """Masked distributed copy of one real part: the i-th selected source
    element (scanned in o1 order) goes to the i-th selected destination
    element (``ops.copy._masked_copy``'s pairing), each from the first
    rank holding it to every rank holding its destination, in one
    ``all_to_all_single``."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    size1 = [1] * len(o1)
    for a, c in enumerate(o0):
        size1[o1.index(c)] = size0[a]
    m0 = np.ones(dim0, bool) if mask0 is None else np.asarray(mask0).astype(bool)
    m1 = np.ones(dim1, bool) if mask1 is None else np.asarray(mask1).astype(bool)
    idx0 = _box_flat_indices(from0, size0, dim0).reshape(size0)
    idx0 = np.transpose(idx0, [o0.index(c) for c in o1]).reshape(-1)
    src_sel = idx0[m0.reshape(-1)[idx0]]
    idx1 = _box_flat_indices(from1, size1, dim1)
    dst_sel = idx1[m1.reshape(-1)[idx1]]
    if src_sel.size != dst_sel.size:
        raise ValueError(f"masked copy: incompatible masks ({src_sel.size} source vs "
                         f"{dst_sel.size} destination selected elements)")
    yl = yl.clone()
    xc = np.stack(np.unravel_index(src_sel, dim0), -1)
    yc = np.stack(np.unravel_index(dst_sel, dim1), -1)

    def inside(coords, box):
        f, s = np.asarray(box[0]), np.asarray(box[1])
        return np.all((coords >= f) & (coords < f + s), axis=-1)

    owner = np.full(len(src_sel), -1)
    for i in reversed(range(n)):
        owner[inside(xc, x_boxes[i])] = i
    holds = [inside(yc, y_boxes[j]) for j in range(n)]

    def lflat(coords, box, shape):
        return np.ravel_multi_index(tuple((coords - np.asarray(box[0])).T), shape)

    send, in_splits = [], []
    for j in range(n):
        sel = (owner == r) & holds[j]
        idx = torch.from_numpy(lflat(xc[sel], x_boxes[r], tuple(xl.shape))).to(xl.device)
        send.append(xl.reshape(-1)[idx])
        in_splits.append(int(sel.sum()))
    out_splits = [int(((owner == i) & holds[r]).sum()) for i in range(n)]
    recv = torch.empty(sum(out_splits), dtype=xl.dtype, device=xl.device)
    dist.all_to_all_single(recv, torch.cat(send).contiguous(), out_splits, in_splits)
    order = np.concatenate([np.nonzero((owner == i) & holds[r])[0] for i in range(n)])
    if order.size:
        dst = torch.from_numpy(lflat(yc[order], y_boxes[r], tuple(yl.shape))).to(yl.device)
        vals = recv if _is_static(alpha) and alpha == 1 else recv * alpha
        flat = yl.reshape(-1)
        if copy_add == "copy":
            flat[dst] = vals.to(yl.dtype)
        else:
            flat.index_add_(0, dst, vals.to(yl.dtype))
    return yl


@_tracked("dist_copy")
def copy(
    alpha,
    x,
    o0: str,
    y,
    o1: str,
    from0=None,
    size0=None,
    from1=None,
    copy_add: str = "copy",
    out_sharding=None,
    mask0=None,
    mask1=None,
):
    """Distributed label-based box copy (public `copy`, dist.h:3534/3583).

    ``x`` and ``y`` are DTensors (or CArrays of them, or plain tensors
    every rank holds); the result is the updated ``y`` with ``y``'s
    sharding, or ``out_sharding``'s if given.  Without a DTensor operand
    it is ``local_copy``.  ``mask0``/``mask1`` are global host masks, as
    ``local_copy`` takes them.  ``o0`` and ``o1`` may hold different
    labels where ``labels.check_isomorphic`` admits them: a label on one
    side only has extent 1 in the copied box (a spin component sliced
    into a field without spin, or the reverse)."""
    if flags.get_debug_level() >= 2:
        from ..utils.testing import verify_copy

        verify_copy(tuple(x.shape), o0, tuple(y.shape), o1, from0, size0, from1, copy_add)
    if _dt(x) is None and _dt(y) is None:
        out = local_copy(alpha, x, o0, y, o1, from0=from0, size0=size0, from1=from1,
                         copy_add=copy_add, mask0=mask0, mask1=mask1)
        return out if out_sharding is None else reshard(out, out_sharding)
    dim0, dim1 = tuple(x.shape), tuple(y.shape)
    from0 = tuple(int(v) for v in from0) if from0 is not None else (0,) * len(o0)
    size0 = tuple(int(v) for v in size0) if size0 is not None else dim0
    from1 = tuple(int(v) for v in from1) if from1 is not None else (0,) * len(o1)
    check_isomorphic(o0, size0, dim0, o1, dim1)
    if copy_add not in ("copy", "add"):
        raise ValueError(f"copy_add must be 'copy' or 'add', got {copy_add!r}")
    x_boxes, y_boxes = _boxes(x, dim0), _boxes(y, dim1)
    if len(x_boxes) != len(y_boxes):
        raise ValueError("x and y live on meshes of different rank counts")
    # labels on one side only have extent 1 in the copy: give each side the
    # other's as trailing axes of extent 1, so that both hold the same labels
    add0 = "".join(c for c in o1 if c not in o0)
    add1 = "".join(c for c in o0 if c not in o1)
    one0, one1 = (1,) * len(add0), (1,) * len(add1)
    o0w, o1w = o0 + add0, o1 + add1
    dim0w, dim1w = dim0 + one0, dim1 + one1
    from0w, size0w, from1w = from0 + (0,) * len(add0), size0 + one0, from1 + (0,) * len(add1)
    x_boxes = [(f + (0,) * len(add0), z + one0) for f, z in x_boxes]
    y_boxes = [(f + (0,) * len(add1), z + one1) for f, z in y_boxes]
    m0 = None if mask0 is None else np.asarray(mask0).reshape(dim0w)
    m1 = None if mask1 is None else np.asarray(mask1).reshape(dim1w)
    xs = cplx.is_carray(x) or cplx.is_carray(y)
    if xs:
        xc = x if cplx.is_carray(x) else cplx.CArray(x, torch.zeros_like(x))
        yc = y if cplx.is_carray(y) else cplx.CArray(y, torch.zeros_like(y))
        ar, ai = cplx._split_scalar(alpha)
        if ai is not None:
            xc, alpha = cplx.scale(alpha, xc), 1
        pairs = list(zip(xc, yc))
    else:
        pairs = [(x, y)]
    outs = []
    x_plain = _dt(x) is None
    for xp, yp in pairs:
        xl, yl = local(xp), local(yp)
        if volume(size0) == 0:
            outs.append(yl)
            continue
        xw, yw = xl.reshape(tuple(xl.shape) + one0), yl.reshape(tuple(yl.shape) + one1)
        if mask0 is not None or mask1 is not None:
            got = _masked_parts(alpha, xw, o0w, yw, o1w, from0w, size0w, from1w, copy_add,
                                x_boxes, y_boxes, dim0w, dim1w, m0, m1)
        else:
            got = _copy_parts(alpha, xw, x_plain, o0w, yw, o1w, from0w, size0w, from1w,
                              copy_add, x_boxes, y_boxes, dim0w, dim1w)
        outs.append(got.reshape(yl.shape))
    if _dt(y) is None:
        out = cplx.CArray(*outs) if xs else outs[0]
    else:
        yref = yc if xs else y
        out = (cplx.CArray(*[from_local(o, p) for o, p in zip(outs, yref)]) if xs
               else from_local(outs[0], y))
    return out if out_sharding is None else reshard(out, out_sharding)


def _label_mesh(x, o: str) -> dict:
    """{mesh axis name: label} of the labels a DTensor operand shards."""
    d = _dt(x)
    if d is None:
        return {}
    from .mesh import sharding_of

    spec = sharding_of(x).spec
    return {nm: o[i] for i, e in enumerate(spec) if e is not None
            for nm in ((e,) if isinstance(e, str) else e)}


def _respec(x, o: str, want: dict):
    """Reshard the DTensor ``x`` (labels ``o``) so that mesh axis m shards
    label ``want[m]`` (None: replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    d = _dt(x)
    pl = []
    for nm in d.device_mesh.mesh_dim_names:
        lab = want.get(nm)
        pl.append(Shard(o.index(lab)) if lab is not None else Replicate())
    if list(pl) == list(d.placements):
        return x
    return cplx.cmap(lambda a: a.redistribute(a.device_mesh, pl), x) \
        if cplx.is_carray(x) else x.redistribute(d.device_mesh, pl)


@_tracked("dist_contraction")
def contraction(
    alpha,
    x0,
    o0: str,
    conj0: bool,
    x1,
    o1: str,
    conj1: bool,
    beta,
    r,
    o_r: str,
    out_sharding=None,
):
    """Distributed contraction r = alpha * x0·x1 + beta * r (dist.h:3631).

    The operands are DTensors on one mesh (or plain tensors every rank
    holds).  Where they disagree on the label a mesh axis shards, ``x1``
    follows ``x0`` (replicated on that axis where its label is not
    ``x0``'s); the local shards are contracted, the mesh axes that shard
    a contracted label are all-reduced, and the result carries the
    surviving labels' sharding, or ``out_sharding`` where given."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    d0, d1 = _dt(x0), _dt(x1)
    if d0 is None and d1 is None:
        out = local_contraction(alpha, x0, o0, conj0, x1, o1, conj1, beta, r, o_r)
        return out if out_sharding is None else reshard(out, out_sharding)
    if d0 is None or d1 is None:
        mesh = (d0 if d0 is not None else d1).device_mesh
        rep = [Replicate()] * mesh.ndim
        make = (lambda a: DTensor.from_local(a, mesh, rep, run_check=False))
        if d0 is None:
            x0 = cplx.cmap(make, x0) if cplx.is_carray(x0) else make(x0)
        else:
            x1 = cplx.cmap(make, x1) if cplx.is_carray(x1) else make(x1)
    mesh = _dt(x0).device_mesh
    m0, m1 = _label_mesh(x0, o0), _label_mesh(x1, o1)
    want1 = {}
    for nm in mesh.mesh_dim_names:
        l0, l1 = m0.get(nm), m1.get(nm)
        if l0 is not None:
            want1[nm] = l0 if l0 in o1 else None
        elif l1 is not None and l1 not in o0:
            want1[nm] = l1
    want0 = {nm: l for nm, l in m0.items()}
    for nm, l in want1.items():
        if l is not None and l in o0 and nm not in want0:
            want0[nm] = l
    used = [l for l in want0.values()]
    for nm, l in list(want1.items()):
        if l is not None and l not in o0 and l in used:
            want1[nm] = None
    x0 = _respec(x0, o0, want0)
    x1 = _respec(x1, o1, want1)
    labels = {**{nm: l for nm, l in want1.items() if l is not None}, **want0}
    y = local_contraction(1.0, local(x0), o0, conj0, local(x1), o1, conj1, 0.0, None, o_r)
    reduce_axes = [nm for nm, l in labels.items() if l not in o_r]
    for nm in reduce_axes:
        for part in (tuple(y) if cplx.is_carray(y) else (y,)):
            dist.all_reduce(part, group=mesh.get_group(nm))
    if not (_is_static(alpha) and alpha == 1):
        y = cplx.scale(alpha, y)
    pl = [Shard(o_r.index(labels[nm])) if nm in labels and labels[nm] in o_r
          else Replicate() for nm in mesh.mesh_dim_names]
    dims = {c: int(s) for o, t in ((o0, x0), (o1, x1)) for c, s in zip(o, t.shape)}
    shape = tuple(dims[c] for c in o_r)

    def wrap(a):
        return DTensor.from_local(a.contiguous(), mesh, pl, run_check=False, shape=shape,
                                  stride=c_strides(shape))

    out = cplx.cmap(wrap, y) if cplx.is_carray(y) else wrap(y)
    if r is not None and not (_is_static(beta) and beta == 0):
        rr = r if _dt(r) is not None else (cplx.cmap(
            lambda a: DTensor.from_local(a, mesh, [Replicate()] * len(pl), run_check=False),
            r) if cplx.is_carray(r) else DTensor.from_local(r, mesh, [Replicate()] * len(pl),
                                                             run_check=False))
        rr = cplx.cmap(lambda a: a.redistribute(mesh, pl), rr) if cplx.is_carray(rr) \
            else rr.redistribute(mesh, pl)
        out = cplx.add(out, cplx.scale(beta, rr))
    return out if out_sharding is None else reshard(out, out_sharding)


def reshard(x, sharding):
    """Reshard a global array (the pure-layout case of distributed copy):
    ``DTensor.redistribute`` on the sharding's own mesh, a plain tensor
    every rank holds sliced locally (``distribute_tensor`` with no
    scatter), else through the redistribution plan."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from .mesh import NamedSharding, device_mesh
    from .redistribute import pack_global_device, unpack_global_device

    if cplx.is_carray(x):
        return cplx.cmap(lambda a: reshard(a, sharding), x)
    if isinstance(sharding, NamedSharding):
        dm = device_mesh(sharding.mesh)
        if not isinstance(x, DTensor):
            return distribute_tensor(x, dm, sharding.placements(), src_data_rank=None)
        if x.device_mesh == dm:
            return x.redistribute(dm, sharding.placements())
    part = Partition(dim=tuple(x.shape), boxes=tuple(sharding.boxes(tuple(x.shape))))
    if len(part.boxes) == 1:
        import torch.distributed as dist

        empty = ((0,) * x.ndim, (0,) * x.ndim)
        part = Partition(dim=part.dim, boxes=tuple(
            part.boxes[0] if i == sharding.rank else empty
            for i in range(dist.get_world_size())))
    return unpack_global_device(pack_global_device(x, part), part, sharding)
