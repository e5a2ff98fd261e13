"""Halo-plan sharded execution of GATHER-mode BSR operators (counterpart
of ``superbblas_tpu/parallel/gather_sharded.py``).

The reference runs general BSR through the same halo machinery as
stencils: the x-gather is a redistribution onto the extended domain
(bsr.h:2020-2192).  Here a host-side plan (the JAX package's, verbatim)
remaps every neighbour index into a halo-extended LOCAL frame, one
exchange per sharded axis moves the boundary planes (corners ride the
sequential per-axis extension), and the gather runs shard-local on the
batched-GEMM kernels (K3/E1) through ``bsr._apply_gather`` /
``bsr._apply_gather_kron``.

Scope: operators whose neighbour lists stay within ``w_a`` planes of the
owning shard along every sharded lattice axis, with w_a <= the local
shard extent.  Unbounded operators raise.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import cplx
from ..bsr import BSROperator, _apply_gather, _apply_gather_kron
from ._local import local_slab, wrap_labels
from .halo import crop_halos as _crop, extend_local as _extend, post_halos
from .mesh import axis_size

__all__ = ["make_gather_halo_plan", "apply_gather_sharded",
           "apply_gather_overlap"]

#: per-operator memo of the plan's device index tensors, keyed on
#: (id(op), sharded axes, mesh, power, all_powers or "overlap", device);
#: entries die with the operator (weakref.finalize)
_GATHER_CACHE: dict = {}
_GATHER_CACHE_MAX = 32
_FINALIZER_KEYS: set = set()


def _cache_get(key):
    hit = _GATHER_CACHE.get(key)
    if hit is not None:
        _GATHER_CACHE[key] = _GATHER_CACHE.pop(key)   # LRU refresh
    return hit


def _cache_put(op, key, value):
    if len(_GATHER_CACHE) >= _GATHER_CACHE_MAX:
        _GATHER_CACHE.pop(next(iter(_GATHER_CACHE)))
    _GATHER_CACHE[key] = value
    if key not in _FINALIZER_KEYS:
        _FINALIZER_KEYS.add(key)
        weakref.finalize(op, _evict, key)


def _evict(key):
    _GATHER_CACHE.pop(key, None)
    _FINALIZER_KEYS.discard(key)


def _np(t):
    return None if t is None else (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                                   else np.asarray(t))


def make_gather_halo_plan(op: BSROperator, lat_axis, nshards,
                          power: int = 1):
    """Host-side halo plan for one or more sharded lattice axes (the JAX
    package's plan, field for field).

    ``lat_axis``/``nshards``: an int pair (one sharded axis) or
    equal-length tuples.  Returns ``(W, jj_local)``: ``W`` the FRAME halo
    width per axis (int for int input) and ``jj_local`` int32
    [n_0, ..., n_{m-1}, rows, nnz] of per-shard neighbour indices in the
    halo-extended local frame (extended-domain index translation,
    bsr.h:2020-2116).  ``power=1``: rows are the shard's core sites;
    ``power=p>1``: every site of the extended frame, W from the p-hop
    plane reachability of the core, every core-feeding row certified to
    read only in-frame operands (else ValueError)."""
    single = np.isscalar(lat_axis)
    ks = (int(lat_axis),) if single else tuple(int(a) for a in lat_axis)
    ns = (int(nshards),) if single else tuple(int(a) for a in nshards)
    if len(ks) != len(ns) or len(set(ks)) != len(ks):
        raise ValueError("lat_axis/nshards must pair distinct axes")
    dim = tuple(op.dim_d)
    if tuple(op.dim_i) != dim:
        raise ValueError("halo-plan gather requires a square operator")
    if power < 1:
        raise ValueError("power must be >= 1")
    for k, n in zip(ks, ns):
        if dim[k] % n:
            raise ValueError(f"lattice axis {k} must divide over {n}")
    Ls = [dim[k] // n for k, n in zip(ks, ns)]
    jj = _np(op.jj_flat)                            # [voli, nnz]
    voli, nnz = jj.shape
    if op.row_counts is not None:
        rc = _np(op.row_counts).reshape(-1)
        jj = np.where(np.arange(nnz)[None, :] < rc[:, None],
                      jj, np.arange(voli, dtype=jj.dtype)[:, None])
    coords = np.stack(np.unravel_index(jj.reshape(-1), dim), axis=-1)
    coords = coords.reshape(voli, nnz, len(dim))
    sites = np.unravel_index(np.arange(voli), dim)

    Ws = []
    for k, n, L in zip(ks, ns, Ls):
        D = dim[k]
        adj = np.zeros((D, D), bool)
        src = np.broadcast_to(sites[k][:, None], (voli, nnz))
        adj[src.reshape(-1), coords[..., k].reshape(-1)] = True
        W = 0
        for r in range(n):
            reach = np.zeros(D, bool)
            reach[r * L:(r + 1) * L] = True
            for _ in range(power):
                reach = reach | adj[reach].any(axis=0)
            pos = (np.nonzero(reach)[0] - r * L) % D
            need = np.where(pos < L, 0, np.minimum(pos - L + 1, D - pos))
            W = max(W, int(need.max(initial=0)))
        if W > L:
            raise ValueError(
                f"gather couplings reach {W} planes past the shard "
                f"(axis {k}: local extent {L}, power {power}): the "
                "one-exchange halo cannot source them — use the "
                "replicated path or a lower power")
        Ws.append(W)

    exts = [L + 2 * W for L, W in zip(Ls, Ws)]
    ext_dim = list(dim)
    for k, e in zip(ks, exts):
        ext_dim[k] = e
    ext_dim = tuple(ext_dim)

    def remap(c, rs):
        lc = [c[..., a] for a in range(len(dim))]
        ok = np.ones(c.shape[:-1], bool)
        for k, L, W, e in zip(ks, Ls, Ws, exts):
            lpos = (c[..., k] - (rs[ks.index(k)] * L - W)) % dim[k]
            ok &= lpos < e
            lc[k] = np.where(lpos >= e, 0, lpos)
        return np.ravel_multi_index(lc, ext_dim), ok

    grid = list(itertools.product(*[range(n) for n in ns]))
    if power == 1:
        rows = voli
        for n in ns:
            rows //= n
        jj_local = np.empty((len(grid), rows, nnz), dtype=np.int64)
        for gi, rs in enumerate(grid):
            sel = np.ones(voli, bool)
            for k, L, r in zip(ks, Ls, rs):
                sel &= (sites[k] >= r * L) & (sites[k] < (r + 1) * L)
            jj_local[gi], ok = remap(coords[sel], rs)
            if not ok.all():
                raise ValueError(
                    "neighbor outside the halo frame (plan width "
                    "miscomputed)")
    else:
        coords_g = coords.reshape(dim + (nnz, len(dim)))
        rows = voli
        for n, L, e in zip(ns, Ls, exts):
            rows = rows // (n * L) * e
        fpos = np.unravel_index(np.arange(rows), ext_dim)
        core = np.ones(rows, bool)
        for k, L, W in zip(ks, Ls, Ws):
            core &= (fpos[k] >= W) & (fpos[k] < W + L)
        jj_local = np.empty((len(grid), rows, nnz), dtype=np.int64)
        for gi, rs in enumerate(grid):
            c = coords_g
            for k, L, W, e, r in zip(ks, Ls, Ws, exts, rs):
                gk = (r * L - W + np.arange(e)) % dim[k]
                c = np.take(c, gk, axis=k)
            flat, ok = remap(c.reshape(-1, nnz, len(dim)), rs)
            ok_nb = ok.all(axis=1)
            valid = ok_nb.copy()
            for _ in range(power - 1):
                valid = ok_nb & valid[flat].all(axis=1)
            if not valid[core].all():
                raise ValueError(
                    "gather couplings escape the communication-avoiding "
                    f"frame within {power} applies (validity "
                    "certification failed) — use a lower power or the "
                    "replicated path")
            jj_local[gi] = flat
    jj_local = jj_local.reshape(ns + jj_local.shape[1:])
    w_out = Ws[0] if single else tuple(Ws)
    if int(jj_local.max(initial=0)) < np.iinfo(np.int32).max:
        jj_local = jj_local.astype(np.int32)
    return w_out, jj_local


def _geometry(op, ks, ns, w):
    Ws = (int(w),) if np.isscalar(w) else tuple(int(v) for v in w)
    Ls = tuple(op.dim_d[k] // n for k, n in zip(ks, ns))
    loc_core, loc_ext = list(op.dim_d), list(op.dim_d)
    for k, L, W in zip(ks, Ls, Ws):
        loc_core[k] = L
        loc_ext[k] = L + 2 * W
    return Ws, Ls, tuple(loc_core), tuple(loc_ext)


def _frame_blocks(op, mesh, shard, Ws, Ls, power):
    """This rank's operator rows: its core slab (power 1) or its extended
    frame (power > 1: the halo sites' rows travel with the field — a
    sharded blocks DTensor through the exchange, replicated blocks by a
    local wrapped index)."""
    from torch.distributed.tensor import DTensor

    b = op.blocks
    bt = b.re if cplx.is_carray(b) else b
    if power == 1:
        return local_slab(b, mesh, shard)
    if isinstance(bt, DTensor):
        wd = {k: W for k, W in zip(shard, Ws) if W}
        return _extend(local_slab(b, mesh, shard), {k: shard[k] for k in wd}, wd, mesh)

    def frame(a):
        for (k, nm), L, W in zip(shard.items(), Ls, Ws):
            r = mesh.get_local_rank(nm)
            idx = (torch.arange(r * L - W, (r + 1) * L + W, device=a.device)
                   % op.dim_d[k])
            a = a.index_select(k, idx)
        return a
    return cplx.cmap(frame, b) if cplx.is_carray(b) else frame(b)


def _local_op(op, blocks, jj, dim_i, dim_d):
    return BSROperator(blocks, op.kron, (), dim_i, op.bi, op.bd, op.ki, op.kd, op.oim,
                       op.odm, "gather", op.blk_i, op.blk_d, op.kron_i, op.kron_d,
                       dim_d=dim_d, jj_flat=jj)


def _plan_for(op, ks, ns, power, plan=None):
    if plan is not None:
        return plan
    if len(ks) == 1:
        return make_gather_halo_plan(op, ks[0], ns[0], power=power)
    return make_gather_halo_plan(op, ks, ns, power=power)


def _gather_local(op: BSROperator, xc, mesh, shard: Dict[int, str], plan=None,
                  power: int = 1, all_powers: bool = False):
    """The sharded gather apply on this rank's canonical local operand
    ``xc`` [*lat_loc, KD?, BD, N]: one exchange per sharded axis, then
    ``power`` local applies; returns the local result (stacked on a new
    leading axis for ``all_powers``)."""
    if power < 1:
        raise ValueError("power must be >= 1")
    ks = tuple(shard)
    nms = tuple(shard.values())
    ns = tuple(axis_size(mesh, nm) for nm in nms)
    coord = tuple(mesh.get_local_rank(nm) for nm in nms)
    dev = (xc.re if cplx.is_carray(xc) else xc).device
    key = (id(op), ks, ns, nms, power, str(dev))
    hit = _cache_get(key) if plan is None else None
    if hit is None:
        w, jj_local = _plan_for(op, ks, ns, power, plan)
        jj_local = np.asarray(jj_local).reshape(ns + np.asarray(jj_local).shape[-2:])
        hit = (w, torch.from_numpy(jj_local[coord].astype(np.int64)).to(dev))
        if plan is None:
            _cache_put(op, key, hit)
    w, jj = hit
    Ws, Ls, loc_core, loc_ext = _geometry(op, ks, ns, w)
    wdict = {k: W for k, W in zip(ks, Ws) if W}
    ndict = {k: shard[k] for k in wdict}
    x_e = _extend(xc, ndict, wdict, mesh) if wdict else xc
    b = _frame_blocks(op, mesh, shard, Ws, Ls, power if wdict else 1)
    lop = _local_op(op, b, jj, loc_core if power == 1 else loc_ext, loc_ext)
    fn = _apply_gather_kron if op.kron is not None else _apply_gather
    outs, cur = [], x_e
    for _ in range(power):
        cur = fn(lop, cur)
        outs.append(cur)
    if not all_powers:
        outs = outs[-1:]
    if power > 1:
        outs = [_crop(o, wdict) if wdict else o for o in outs]
    if not all_powers:
        return outs[0]
    if cplx.is_carray(outs[0]):
        return cplx.CArray(torch.stack([o.re for o in outs]),
                           torch.stack([o.im for o in outs]))
    return torch.stack(outs)


def _sharded(op, x, mesh, axes, fname):
    if op.mode != "gather":
        raise ValueError("requires a gather-mode operator")
    shard = {k: axes[c] for k, c in enumerate(op.lat_d)
             if axes.get(c) is not None and axis_size(mesh, axes[c]) > 1}
    if not shard:
        raise ValueError(f"{fname}: no sharded lattice axis")
    return shard


def _canon_labels(op, x):
    nlat = len(op.dim_d)
    nd = (x.re if cplx.is_carray(x) else x).ndim
    return op.lat_d + "".join(chr(0x100 + i) for i in range(nd - nlat))


def apply_gather_sharded(op: BSROperator, x, mesh,
                         axes: Dict[str, Optional[str]],
                         plan: Optional[Tuple] = None,
                         power: int = 1, all_powers: bool = False):
    """y = A x for a GATHER-mode operator on a lattice-sharded operand
    through one exchange per sharded axis (the reference's
    extended-domain BSR matvec, bsr.h:2020-2192).

    ``x``: canonical AoS [*lat, KD?, BD, N], a DTensor (or CArray of them)
    sharded on lattice axes per ``axes`` (or a plain tensor every rank
    holds); the operator's blocks are replicated (plain) or sharded the
    same way.  Returns the input's sharding.  ``plan``: a precomputed
    :func:`make_gather_halo_plan` result for the sharded axes (same
    ``power``); else it is memoised per (operator, mesh, axes, power).
    ``power=p`` computes A^p x with ONE widened exchange per axis (the
    halo sites' operator rows travel with the field); ``all_powers=True``
    returns [A x, ..., A^p x] on a new leading axis."""
    shard = _sharded(op, x, mesh, axes, "apply_gather_sharded")
    lab = _canon_labels(op, x)
    xl = local_slab(x, mesh, shard)
    y = _gather_local(op, xl, mesh, shard, plan=plan, power=power, all_powers=all_powers)
    shape = tuple(x.shape)
    if all_powers:
        lab, shape = "ÿ" + lab, (power,) + shape
    return wrap_labels(y, mesh, lab, {op.lat_d[k]: nm for k, nm in shard.items()}, shape)


def _gather_overlap_local(op: BSROperator, xc, mesh, shard: Dict[int, str],
                          just_local: bool = False):
    """The core/crossing split on this rank's canonical local operand:
    the first sharded axis's exchange is posted asynchronously, the core
    gather (slots whose neighbour lies in the local slab) runs on the
    un-extended block meanwhile, then the crossing gather on the
    extended frame is added."""
    ks = tuple(shard)
    nms = tuple(shard.values())
    ns = tuple(axis_size(mesh, nm) for nm in nms)
    coord = tuple(mesh.get_local_rank(nm) for nm in nms)
    dev = (xc.re if cplx.is_carray(xc) else xc).device
    key = (id(op), "overlap", ks, ns, nms, str(dev))
    hit = _cache_get(key)
    if hit is None:
        W, jj_local = _plan_for(op, ks, ns, 1)
        Ws, Ls, loc_core, loc_ext = _geometry(op, ks, ns, W)
        jj_arr = np.asarray(jj_local).astype(np.int64)
        fco = np.unravel_index(jj_arr, loc_ext)
        is_core = np.ones(jj_arr.shape, bool)
        for k, L, Wa in zip(ks, Ls, Ws):
            is_core &= (fco[k] >= Wa) & (fco[k] < Wa + L)
        lco = list(fco)
        for k, Wa in zip(ks, Ws):
            lco[k] = np.where(is_core, fco[k] - Wa, 0)
        jj_core = np.where(is_core, np.ravel_multi_index(lco, loc_core), 0)
        jj_halo = np.where(is_core, 0, jj_arr)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a[coord])).to(dev)  # noqa: E731
        hit = (W, bool(is_core.all()), t(jj_core), t(jj_halo), t(is_core))
        _cache_put(op, key, hit)
    W, all_core, jjc, jjh, mk = hit
    if all_core:
        # nothing crosses: the plain single apply is the overlap result
        return _gather_local(op, xc, mesh, shard)
    Ws, Ls, loc_core, loc_ext = _geometry(op, ks, ns, W)
    wdict = {k: Wa for k, Wa in zip(ks, Ws) if Wa}
    ndict = {k: shard[k] for k in wdict}
    blocks = local_slab(op.blocks, mesh, shard)

    def masked(m):
        msk = m.reshape(tuple(loc_core) + (m.shape[-1], 1, 1))
        mul = lambda b: b * msk.to(b.dtype)  # noqa: E731
        return cplx.cmap(mul, blocks) if cplx.is_carray(blocks) else mul(blocks)

    fn = _apply_gather_kron if op.kron is not None else _apply_gather
    posted = None
    if not just_local:
        (k0, nm0), rest = next(iter(ndict.items())), dict(list(ndict.items())[1:])
        parts = list(xc) if cplx.is_carray(xc) else [xc]
        posted = post_halos(parts, k0, nm0, wdict[k0], mesh, async_op=True)
    y = fn(_local_op(op, masked(mk), jjc, loc_core, loc_core), xc)
    if just_local:
        return y
    got = posted.wait()
    ext = [torch.cat([lo, p, hi], dim=k0) for p, (lo, hi) in zip(parts, got)]
    x_e = cplx.CArray(*ext) if cplx.is_carray(xc) else ext[0]
    if rest:
        x_e = _extend(x_e, rest, {k: wdict[k] for k in rest}, mesh)
    yh = fn(_local_op(op, masked(~mk), jjh, loc_core, loc_ext), x_e)
    return cplx.add(y, yh)


def apply_gather_overlap(op: BSROperator, x, mesh,
                         axes: Dict[str, Optional[str]],
                         just_local: bool = False):
    """y = A x for a GATHER-mode operator with an explicit core/halo
    split (the reference's create_lattice_split scheme on irregular
    operators; tests/bsr.cpp:402-530, just_local bsr.h:2359): the core
    slots gather from the un-extended local block while the exchange is
    in flight, the crossing slots from the extended frame afterwards.
    ``just_local=True`` returns only the core contribution.  Memoised per
    (operator, mesh, axes) like :func:`apply_gather_sharded`."""
    shard = _sharded(op, x, mesh, axes, "apply_gather_overlap")
    lab = _canon_labels(op, x)
    xl = local_slab(x, mesh, shard)
    y = _gather_overlap_local(op, xl, mesh, shard, just_local=just_local)
    return wrap_labels(y, mesh, lab, {op.lat_d[k]: nm for k, nm in shard.items()},
                       tuple(x.shape))
