"""One rank of a gloo group that runs the distributed parity cases of a
test file on ``superbblas_tpu_torch`` (it imports no JAX).

    python tests/_torch_dist_worker.py SUITE CASE_DIR RANK WORLD PORT

reads ``CASE_DIR/cases.pkl`` ([(name, kind, params)], numpy inputs),
runs every case in order on a gloo group of WORLD processes on the CPU,
and writes this rank's results to ``CASE_DIR/out_rank{RANK}.pkl`` after
each case ({name: {key: numpy array}}, or {"error": traceback})."""

from __future__ import annotations

import io
import os
import pickle
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from superbblas_tpu_torch import cplx, flags  # noqa: E402
from superbblas_tpu_torch import parallel as par  # noqa: E402
from superbblas_tpu_torch.parallel import redistribute as R  # noqa: E402

_MESHES: dict = {}


def mesh(shape, names):
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = par.make_mesh(dict(zip(names, shape)), "cpu")
    return _MESHES[key]


def T(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def carr(re, im=None):
    return cplx.CArray(T(re), T(im)) if im is not None else T(re)


def shard(x, m, spec):
    """A global numpy array (or (re, im) pair) as a DTensor on ``m``."""
    from torch.distributed.tensor import distribute_tensor

    pl = par.NamedSharding(m, par.PartitionSpec(*spec)).placements()
    d = lambda a: distribute_tensor(T(a), m, pl, src_data_rank=None)  # noqa: E731
    return cplx.CArray(d(x[0]), d(x[1])) if isinstance(x, tuple) else d(x)


def full(x):
    """A DTensor (CArray) as global numpy ((re, im) for a CArray)."""
    from torch.distributed.tensor import DTensor

    g = lambda a: (a.full_tensor() if isinstance(a, DTensor) else a).double().numpy()  # noqa
    return (g(x.re), g(x.im)) if cplx.is_carray(x) else g(x)


def local(x):
    from torch.distributed.tensor import DTensor

    g = lambda a: (a.to_local() if isinstance(a, DTensor) else a).double().numpy()  # noqa
    return (g(x.re), g(x.im)) if cplx.is_carray(x) else g(x)


def part(p):
    return par.Partition(dim=tuple(p[0]), boxes=tuple(p[1]))


def set_env(**kw):
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    flags.clear_cache()
    R.make_plan.cache_clear()


# ---------------------------------------------------------------------------
# redistribute


def k_explicit(p):
    src, dst = part(p["src"]), part(p["dst"])
    set_env(SBT_REDIST_PACK=p.get("pack"), SBT_DEBUG=p.get("debug"))
    try:
        xs = [R.pack_global(p["x"], src)] + ([R.pack_global(p["x_im"], src)]
                                             if p.get("x_im") is not None else [])
        st = carr(*xs)
        out_dtype = getattr(torch, p["out_dtype"]) if p.get("out_dtype") else None
        out = R.redistribute_explicit(st, src, dst, None, copy_add=p.get("copy_add", "copy"),
                                      method=p.get("method", "auto"),
                                      mask_src=p.get("mask_src"), mask_dst=p.get("mask_dst"),
                                      perm=p.get("perm"), alpha=p.get("alpha"),
                                      out_dtype=out_dtype)
        plan = R.make_plan(src, dst, p.get("copy_add", "copy"), mask_src=p.get("mask_src"),
                           mask_dst=p.get("mask_dst"), perm=p.get("perm"))
        lo = local(out)
        res = {"out": tuple(a[0] for a in lo) if isinstance(lo, tuple) else lo[0],
               "pack": plan.pack,
               "dtype": str((out.re if cplx.is_carray(out) else out).dtype)}
    finally:
        set_env(SBT_REDIST_PACK=None, SBT_DEBUG=None)
    return res


def k_replay_corrupt(p):
    """SBT_DEBUG=2 replay: a sane plan passes, a corrupted cached plan
    raises on every rank together."""
    src, dst = part(p["src"]), part(p["dst"])
    set_env(SBT_DEBUG=2)
    try:
        st = T(R.pack_global(p["x"], src))
        ok = local(R.redistribute_explicit(st, src, dst, None))[0]
        plan = R.make_plan(src, dst)
        keys = sorted(plan.pair_pieces, key=lambda k: k[1])
        done = False
        for a in range(len(keys)):
            for b in range(a + 1, len(keys)):
                ka, kb = keys[a], keys[b]
                if ka[1] != kb[1]:
                    continue
                pa, pb = plan.pair_pieces[ka], plan.pair_pieces[kb]
                if (pa[0, 2] == pb[0, 2]).all():
                    pa, pb = pa.copy(), pb.copy()
                    pa[0, 1], pb[0, 1] = pb[0, 1].copy(), pa[0, 1].copy()
                    plan.pair_pieces[ka], plan.pair_pieces[kb] = pa, pb
                    done = True
                    break
            if done:
                break
        plan.__dict__.pop("_device_idx", None)
        try:
            R.redistribute_explicit(st, src, dst, None)
            raised = ""
        except RuntimeError as e:
            raised = str(e)
    finally:
        set_env(SBT_DEBUG=None)
    return {"ok": ok, "corrupted": done, "raised": raised}


def k_auto(p):
    src, dst = part(p["src"]), part(p["dst"])
    x = p["x"]
    if p.get("x_mesh") is not None:
        m = mesh(*p["x_mesh"])
        xin = shard(x, m, p["x_spec"])
    else:
        xin = T(x)
    out_dtype = getattr(torch, p["out_dtype"]) if p.get("out_dtype") else None
    out = par.redistribute_auto(xin, src, dst, order=p["order"], copy_add=p.get("copy_add",
                                                                               "copy"),
                                method=p.get("method", "auto"), order_dst=p.get("order_dst"),
                                alpha=p.get("alpha"), out_dtype=out_dtype,
                                mask_src=p.get("mask_src"), mask_dst=p.get("mask_dst"))
    from torch.distributed.tensor import DTensor

    is_dt = isinstance(out, DTensor)
    return {"full": full(out) if is_dt else out.double().numpy(), "dtensor": is_dt,
            "placements": str(out.placements) if is_dt else ""}


# ---------------------------------------------------------------------------
# dist: copy / contraction / reshard


def _operand(p, key):
    v = p[key]
    spec = p.get(key + "_spec")
    if spec is None:
        return T(v) if not isinstance(v, tuple) else carr(*v)
    return shard(v, mesh(*p["mesh"]), spec)


def k_copy(p):
    x, y = _operand(p, "x"), _operand(p, "y")
    out = par.copy(p["alpha"], x, p["o0"], y, p["o1"], from0=p.get("from0"),
                   size0=p.get("size0"), from1=p.get("from1"),
                   copy_add=p.get("copy_add", "copy"), mask0=p.get("mask0"),
                   mask1=p.get("mask1"))
    return {"full": full(out)}


def k_contraction(p):
    x0, x1 = _operand(p, "x0"), _operand(p, "x1")
    r = _operand(p, "r") if p.get("r") is not None else None
    out = par.contraction(p["alpha"], x0, p["o0"], p.get("conj0", False), x1, p["o1"],
                          p.get("conj1", False), p.get("beta", 0.0), r, p["o_r"])
    from torch.distributed.tensor import DTensor

    a = out.re if cplx.is_carray(out) else out
    return {"full": full(out), "placements": str(a.placements)
            if isinstance(a, DTensor) else ""}


def k_reshard(p):
    x = _operand(p, "x")
    m = mesh(*p["to_mesh"])
    out = par.reshard(x, par.NamedSharding(m, par.PartitionSpec(*p["to_spec"])))
    return {"full": full(out), "local": local(out), "placements": str(out.placements)}


def k_dense(p):
    """A dense op on operands whose batch labels are sharded."""
    from superbblas_tpu_torch import dense

    fn = p["fn"]
    try:
        if fn in ("cholesky", "inversion"):
            out = getattr(dense, fn)(_operand(p, "a"), p["oa"], p["orows"], p["ocols"])
        else:
            out = getattr(dense, fn)(p.get("alpha", 1.0), _operand(p, "a"), p["oa"],
                                     p["orows"], p["ocols"], _operand(p, "x"), p["ox"],
                                     p["oy"])
    except ValueError as e:
        return {"raised": str(e)}
    from torch.distributed.tensor import DTensor

    a = out.re if cplx.is_carray(out) else out
    return {"full": full(out), "placements": str(a.placements)
            if isinstance(a, DTensor) else "", "raised": ""}


# ---------------------------------------------------------------------------
# halos and the sharded SoA stencil


def k_exchange_halos(p):
    m = mesh(*p["mesh"])
    x = shard(p["x"], m, p["spec"])
    ext = par.exchange_halos(x, m, par.PartitionSpec(*p["spec"]), p["widths"])
    crop = par.crop_halos(ext.to_local(), p["widths"])
    return {"local": local(ext), "crop": crop.double().numpy(),
            "core": local(x), "shape": tuple(ext.shape)}


def _wilson(p):
    from superbblas_tpu_torch.models import wilson as W

    dt = torch.complex128 if p.get("f64", True) else torch.complex64
    return W.wilson_operator(tuple(p["lat"]), mass=p["mass"], key=p["key"], dtype=dt,
                             layout=p.get("layout", "soa"), device="cpu")


def _shard_op(op, m, spec):
    return op.replace(blocks=shard((op.blocks.re.numpy(), op.blocks.im.numpy()), m, spec))


def k_stencil_sharded(p):
    m = mesh(*p["mesh"])
    op = _wilson(p)
    spec = p["spec"]
    ops = _shard_op(op, m, spec)
    x = shard(p["x"], m, spec)
    y = par.apply_stencil_soa_sharded(ops, x, m, p["axes"], power=p.get("power", 1))
    from superbblas_tpu_torch import bsr

    lx = bsr.apply_stencil_soa(op, carr(*p["x"]))
    for _ in range(p.get("power", 1) - 1):
        lx = bsr.apply_stencil_soa(op, lx)
    return {"full": full(y), "local": local(y), "unsharded": local(lx),
            "placements": str(y.re.placements)}


def k_sharded_solve(p):
    """The slice's path: a sharded Wilson CG on the normal equations, the
    solution checkpointed (one S3T block per rank), reloaded into a
    different sharding, moved to an uneven partition and on master."""
    from superbblas_tpu_torch import solvers, storage as S
    from superbblas_tpu_torch.models import wilson as W

    m = mesh(*p["mesh"])
    op = _wilson(p)
    oph = W.adjoint_operator(op)
    spec, axes = p["spec"], p["axes"]
    ops, ophs = _shard_op(op, m, spec), _shard_op(oph, m, spec)
    b = shard(p["b"], m, spec)

    def A(v):
        return par.apply_stencil_soa_sharded(ophs, par.apply_stencil_soa_sharded(
            ops, v, m, axes), m, axes)

    rhs = par.apply_stencil_soa_sharded(ophs, b, m, axes)
    hist = []
    for k in p["iters"]:
        x, rs, it = solvers.cg(A, rhs, tol=0.0, maxiter=k)
        hist.append(float(rs))
    out = {"x": full(x), "hist": np.asarray(hist), "it": it}
    # checkpoint -> reload on another sharding -> uneven -> on master
    path = p["path"]
    sto = S.create_storage_sharded(path, "nfxyzt", tuple(x.re.shape), dtype=np.complex128)
    S.save_sharded(sto, x, "nfxyzt")
    S.close_storage_sharded(sto)
    sto = S.open_storage(path, mode="r")
    m2 = mesh(*p["mesh2"])
    back = S.load_sharded(sto, par.NamedSharding(m2, par.PartitionSpec(*p["spec2"])))
    S.close_storage(sto)
    out["reload_local"] = local(back)
    out["reload_full"] = full(back)
    out["blocks"] = len(S.open_storage(path, mode="r").blocks)
    order = "nfxyzt"
    src = par.sharding_partition(back.re, tuple(back.re.shape))
    uneven = part(p["uneven"])
    un = par.redistribute_auto(back, src, uneven, order=order)
    out["uneven_full"] = full(un)
    master = par.Partition(dim=uneven.dim, boxes=(((0,) * 6, uneven.dim),) + tuple(
        ((0,) * 6, (0,) * 6) for _ in range(len(uneven.boxes) - 1)))
    om = par.redistribute_auto(un, uneven, master, order=order)
    out["master"] = local(om)
    return out


def _fresh_apply(op, xs, m, axes, power=1):
    """The sharded SoA apply as it was before the blocks were held: the
    rank's blocks and field halo-extended together (one exchange an axis)
    on every call, then K1 ``power`` times and the core cropped."""
    from superbblas_tpu_torch import bsr
    from superbblas_tpu_torch.parallel import _local as L, halo

    lat = {2 + k: axes[c] for k, c in enumerate(op.lat_d) if c in axes}
    wd = {k: power for k in lat}
    be, xe = halo.extend_local([L.local_slab(op.blocks, m, lat), L.local(xs)], lat, wd, m)
    lop = op.replace(blocks=be, kron=L.local(op.kron), dim=tuple(xe.re.shape[2:]))
    for _ in range(power):
        xe = bsr.apply_stencil_soa(lop, xe)
    return halo.crop_halos(xe, wd)


def k_held_blocks(p):
    """The held halo-extended blocks of the sharded SoA apply
    (``parallel.halo.extend_held``) on an X-sharded Wilson-clover
    operator: each apply against ``_fresh_apply``, bit for bit, with the
    build and reuse counters and the memo's entries around every step."""
    import gc

    from superbblas_tpu_torch import bsr
    from superbblas_tpu_torch.models import clover as C
    from superbblas_tpu_torch.parallel import _local as L, halo
    from superbblas_tpu_torch.utils import caches, tracker

    m = mesh(*p["mesh"])
    spec, axes = p["spec"], p["axes"]
    op = C.wilson_clover_operator(tuple(p["lat"]), mass=p["mass"], c_sw=p["c_sw"],
                                  key=p["key"], dtype=torch.complex64, layout="soa",
                                  device="cpu")
    ops = C.CloverOperator(hop=_shard_op(op.hop, m, spec), clover=_shard_op(op.clover, m, spec),
                           c_sw=op.c_sw)
    xs = [shard(tuple(a.astype(np.float32) for a in x), m, spec) for x in p["xs"]]
    out = {}
    last = dict(builds=0, reuses=0)

    def step():
        """(builds, reuses, entries) since the last step."""
        c = tracker.counters()
        b, r = c.get("halo.block_builds", 0), c.get("halo.block_reuses", 0)
        d = (b - last["builds"], r - last["reuses"], halo.held_usage()["entries"])
        last.update(builds=b, reuses=r)
        return d

    def same(y, want):
        return all(torch.equal(a, b) for a, b in zip(L.local(y), want))

    def clover_fresh(o, x):
        lcl = o.clover.replace(blocks=L.local(o.clover.blocks))
        return cplx.add(_fresh_apply(o.hop, x, m, axes), bsr.apply_stencil_soa(lcl, L.local(x)))

    halo._HELD.clear()
    step()
    out["applies"] = [same(C.apply_clover(ops, x), clover_fresh(ops, x)) for x in xs]
    out["after_applies"] = step()
    usage = halo.held_usage()
    out["bytes"] = usage["bytes"]
    out["report"] = caches.report_cache_usage(io.StringIO())["held_halo_blocks"]
    # the clover term alone: radius 0, nothing to extend, nothing held
    y = bsr.apply_stencil_soa(ops.clover, xs[0])
    out["clover_term"] = (same(y, bsr.apply_stencil_soa(
        ops.clover.replace(blocks=L.local(ops.clover.blocks)), L.local(xs[0]))),) + step()
    # an operator rebuilt around the same blocks takes the held ones
    again = ops.hop.replace(offsets=ops.hop.offsets)
    out["same_blocks"] = (same(bsr.apply_stencil_soa(again, xs[1]),
                               _fresh_apply(again, xs[1], m, axes)),) + step()
    # an in-place change of the blocks (through the DTensor) builds again
    ops.hop.blocks_re.mul_(0.5)
    out["inplace"] = (same(bsr.apply_stencil_soa(ops.hop, xs[0]),
                           _fresh_apply(ops.hop, xs[0], m, axes)),) + step()
    # and so does one made on the rank's shard
    L.local(ops.hop.blocks_im).mul_(2.0)
    out["inplace_local"] = (same(bsr.apply_stencil_soa(ops.hop, xs[1]),
                                 _fresh_apply(ops.hop, xs[1], m, axes)),) + step()
    # another power builds again, and is held beside the first
    y2 = par.apply_stencil_soa_sharded(ops.hop, xs[2], m, axes, power=2)
    out["power"] = (same(y2, _fresh_apply(ops.hop, xs[2], m, axes, power=2)),) + step()
    # a new operator builds again; its entry goes when it is deleted
    new = ops.hop.replace(blocks=cplx.cmap(lambda a: a * 1.0, ops.hop.blocks))
    out["new_op"] = (same(bsr.apply_stencil_soa(new, xs[1]),
                          _fresh_apply(new, xs[1], m, axes)),) + step()
    del new
    gc.collect()
    out["deleted"] = step()
    # blocks every rank holds whole are held by the tensor they are cut from
    out["plain"] = [same(bsr.apply_stencil_soa(op.hop, x), _fresh_apply(op.hop, x, m, axes))
                    for x in xs[:2]] + list(step())
    # inference tensors keep no version: extended on every call, never held
    with torch.inference_mode():
        inf = op.hop.replace(blocks=cplx.cmap(torch.clone, op.hop.blocks))
    out["inference"] = [same(bsr.apply_stencil_soa(inf, x), _fresh_apply(inf, x, m, axes))
                        for x in xs[:2]] + list(step())
    caches.clear_caches()
    out["cleared"] = step()
    out["after_clear"] = (same(bsr.apply_stencil_soa(ops.hop, xs[1]),
                               _fresh_apply(ops.hop, xs[1], m, axes)),) + step()
    return out


def k_refusal(p):
    """Each kernel wrapper refuses a sharded DTensor operand, naming the
    distributed function to use; a reduced inner product reads the global
    value."""
    from superbblas_tpu_torch import bsr
    from superbblas_tpu_torch.ops import batched_gemm, cg_update, permute, stencil

    m = mesh(*p["mesh"])
    op = _wilson(p)
    ops = _shard_op(op, m, p["spec"])
    x = shard(p["x"], m, p["spec"])
    b = shard(np.ones((4, 3, 3)), m, ("X", None, None))
    calls = {
        "stencil_matvec_soa": lambda: stencil.stencil_matvec_soa(
            ops.blocks, op.kron, x, op.offsets, 3, 3),
        "batched_small_gemm": lambda: batched_gemm.batched_small_gemm(b, b),
        "batched_gemm_rowpack": lambda: batched_gemm.batched_gemm_rowpack(b, b),
        "maybe_permute": lambda: permute.maybe_permute(x.re, (0, 1, 5, 3, 4, 2)),
        "permute_4d": lambda: permute.permute_4d(b, (2, 1, 0)),
        "stencil_matvec_soa_rt": lambda: stencil.stencil_matvec_soa_rt(
            ops.blocks, op.kron, x, op.offsets, 3, 3),
        "cg_dot": lambda: cg_update.cg_dot(x, x),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    # one level up, the ordinary entry point takes the DTensor to the
    # sharded apply (the wrappers above see only local shards)
    out["entry"] = str(bsr.apply_stencil_soa(ops, x).re.placements)
    out["inner"] = float(cplx.inner_real(x, x))
    out["local_inner"] = float((x.re.to_local() ** 2).sum() + (x.im.to_local() ** 2).sum())
    return out


# ---------------------------------------------------------------------------
# overlap / CA powers / sharded gather


def _stencil_op(p):
    from superbblas_tpu_torch import bsr

    dim = tuple(p["dim"])
    lat = "XY"[:len(dim)]
    return bsr.bsr_from_stencil(lat + "s", lat + "s", dim, {"s": p["BI"]}, {"s": p["BD"]},
                                p["offs"], T(p["vals"]), device="cpu")


def _gather_op(p):
    from superbblas_tpu_torch import bsr

    if p.get("kr") is not None:
        return bsr.create_kron_bsr(*p["args"], T(p["vals"]), T(p["kr"]), device="cpu")
    return bsr.create_bsr(*p["args"], T(p["vals"]), device="cpu")


def _op(p):
    k = p["op"]
    return _stencil_op(p) if k == "stencil" else _wilson(p) if k == "wilson" else _gather_op(p)


def _x(p, key="x"):
    v = p[key]
    if p.get(key + "_spec") is None:
        return carr(*v) if isinstance(v, tuple) else T(v)
    return shard(v, mesh(*p["mesh"]), p[key + "_spec"])


def k_overlap(p):
    op, m = _op(p), mesh(*p["mesh"])
    y0 = _x(p, "y") if p.get("y") is not None else None
    out = par.bsr_krylov_overlap(p["alpha"], op, _x(p), p["ox"], m, p["axes"],
                                 beta=p.get("beta", 0.0), y=y0, just_local=p.get("just_local",
                                                                                False))
    return {"full": full(out)}


def k_powers(p):
    op, m = _op(p), mesh(*p["mesh"])
    out = par.bsr_krylov_ca(p["alpha"], op, _x(p), p["ox"], m, p["axes"], p["power"],
                            okr=p.get("okr", "p"))
    return {"full": full(out)}


def k_gather(p):
    op, m = _op(p), mesh(*p["mesh"])
    x = _x(p)
    if p.get("overlap"):
        out = par.apply_gather_overlap(op, x, m, p["axes"], just_local=p.get("just_local",
                                                                            False))
    else:
        out = par.apply_gather_sharded(op, x, m, p["axes"], power=p.get("power", 1),
                                       all_powers=p.get("all_powers", False))
    return {"full": full(out)}


def k_raises(p):
    """The call raises the expected error (every rank the same)."""
    op, m = _op(p), mesh(*p["mesh"])
    try:
        if p["fn"] == "powers":
            par.bsr_krylov_ca(1.0, op, _x(p), p["ox"], m, p["axes"], p["power"])
        elif p["fn"] == "gather":
            par.apply_gather_sharded(op, _x(p), m, p["axes"], power=p.get("power", 1))
        return {"raised": ""}
    except (ValueError, NotImplementedError) as e:
        return {"raised": f"{type(e).__name__}: {e}"}


# ---------------------------------------------------------------------------
# the ordinary entry points on sharded operands


def _family(p):
    from superbblas_tpu_torch.models import clover as C, domain_wall as D, staggered as S
    from superbblas_tpu_torch.models import wilson as W

    f, lat = p["family"], tuple(p["lat"])
    kw = dict(links=p["links"], dtype=torch.complex128, layout=p["layout"], device="cpu")
    if f == "wilson":
        return W.wilson_operator(lat, mass=p["mass"], **kw), W.apply_wilson
    if f == "twisted":
        return W.twisted_mass_operator(lat, mass=p["mass"], mu=p["mu"], **kw), W.apply_wilson
    if f == "clover":
        return C.wilson_clover_operator(lat, mass=p["mass"], c_sw=p["c_sw"], **kw), \
            C.apply_clover
    if f == "staggered":
        return S.staggered_operator(lat, mass=p["mass"], **kw), S.apply_staggered
    return D.mobius_operator(lat, Ls=p["Ls"], M5=p["M5"], m_f=p["m_f"], b5=p["b5"],
                             c5=p["c5"], **kw), D.apply_domain_wall


def _comms(fn):
    """fn() and the collectives it made ({op name: count})."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as c:
        out = fn()
    return out, {str(k).split("'")[1] if "'" in str(k) else str(k): int(v)
                 for k, v in c.get_comm_counts().items()}


def k_entry_apply(p):
    """A family's apply on a sharded field (and sharded blocks where
    ``blocks_spec``), against the same call on the whole field."""
    m = mesh(*p["mesh"])
    op, apply = _family(p)
    if p.get("blocks_spec") is not None:
        op = op.replace(blocks=shard((op.blocks.re.numpy(), op.blocks.im.numpy()), m,
                                     p["blocks_spec"]))
    x = shard(p["x"], m, p["spec"])
    y, comms = _comms(lambda: apply(op, x))
    plain_op, _ = _family(p)
    return {"full": full(y), "local": local(y), "plain": local(apply(plain_op, carr(*p["x"]))),
            "comms": comms, "placements": str(y.re.placements)}


def k_entry_solve(p):
    from superbblas_tpu_torch.models import eo_packed as EP, even_odd as EO, wilson as W

    m = mesh(*p["mesh"])
    op, _ = _family(p)
    if p.get("blocks_spec") is not None:
        op = op.replace(blocks=shard((op.blocks.re.numpy(), op.blocks.im.numpy()), m,
                                     p["blocks_spec"]))
    b = shard(p["b"], m, p["spec"])
    plain_op, _ = _family(p)
    fn = {"cg": lambda o, v: W.cg_solve(o, v, n_iters=p["iters"]),
          "eo_packed": lambda o, v: EP.eo_solve_packed_soa(o, v, p["a"], p["iters"]),
          "eo_packed_aos": lambda o, v: EP.eo_solve_packed(o, v, p["a"], p["iters"]),
          "eo_masked": lambda o, v: EO.eo_solve(o, v, p["a"], p["iters"])}[p["fn"]]
    (x, rs), comms = _comms(lambda: fn(op, b))
    xp, rsp = fn(plain_op, carr(*p["b"]))
    out = {"full": full(x), "rs": float(rs), "plain": local(xp), "rs_plain": float(rsp),
           "comms": comms}
    if p["fn"] == "eo_masked":
        even, _ = EO._masks(op.dim_i, b, len(op.dim_i))
        out["mask"] = even.numpy()
        from superbblas_tpu_torch.parallel._local import shard_origin

        out["origin"] = shard_origin(b)
    return out


def k_fused_cgne(p):
    """A Wilson CGNE at f32 on fields sharded as ``spec`` (the blocks
    replicated), through the ordinary applies, with ``solvers.cg``'s loop
    on the fused kernels' plain versions (``solvers._fusable`` forced, so
    that they take the CPU shards) and on the PyTorch ops."""
    from superbblas_tpu_torch import solvers
    from superbblas_tpu_torch.models import wilson as W
    from superbblas_tpu_torch.utils import tracker

    m = mesh(*p["mesh"])
    op = _wilson(dict(p, f64=False))
    oph = W.adjoint_operator(op)
    b = shard(p["b"], m, p["spec"])
    out = {}
    for name, fused in (("fused", True), ("ops", False)):
        before = tracker.counters().get("solver.fused_iterations", 0)
        saved = solvers._fusable
        if fused:
            solvers._fusable = lambda *args: True
        try:
            x, rs, k = solvers.cgne(lambda v: W.apply_wilson(op, v),
                                    lambda v: W.apply_wilson(oph, v), b, tol=p["tol"],
                                    maxiter=p["maxiter"])
        finally:
            solvers._fusable = saved
        out[name] = {"x": full(x), "rs": float(rs), "k": k,
                     "rs_placements": str(getattr(rs, "placements", None)),
                     "fused": tracker.counters().get("solver.fused_iterations", 0) - before}
    out["b"] = full(b)
    return out


def k_entry_packed(p):
    """cb_pack_soa / the packed hopping / cb_unpack_soa on sharded fields
    against the plain calls (the packed X is sharded over ``X``, Y over
    ``Y``: a rank's packing and its halo'd block start at odd y)."""
    from superbblas_tpu_torch.models import eo_packed as EP
    from superbblas_tpu_torch.parallel._local import shard_origin

    m = mesh(*p["mesh"])
    op, _ = _family(p)
    b = shard(p["x"], m, p["spec"])
    bp = carr(*p["x"])
    out = {"origin": shard_origin(b)}
    for par_ in (0, 1):
        packed = EP.cb_pack_soa(b, par_)
        out[f"pack{par_}"] = full(packed)
        hop = EP.hopping_packed_soa(op, 1 - par_)
        y, comms = _comms(lambda: EP.apply_hopping_packed_soa(hop, packed, 1 - par_))
        out[f"hop{par_}"] = local(y)
        out[f"comms{par_}"] = comms
        hp = EP.hopping_packed_soa(op, 1 - par_)
        out[f"hop{par_}_plain"] = local(EP.apply_hopping_packed_soa(
            hp, EP.cb_pack_soa(bp, par_), 1 - par_))
    out["unpack"] = full(EP.cb_unpack_soa(EP.cb_pack_soa(b, 0), EP.cb_pack_soa(b, 1)))
    return out


def k_entry_krylov(p):
    """bsr_krylov on a sharded field: gather mode, powers with okr, an SoA
    operator in any order."""
    from superbblas_tpu_torch import bsr

    m = mesh(*p["mesh"])
    op = _op(p) if p["op"] != "family" else _family(p)[0]
    x = shard(p["x"], m, p["spec"])
    y0 = shard(p["y"], m, p["y_spec"]) if p.get("y") is not None else None
    out, comms = _comms(lambda: bsr.bsr_krylov(p["alpha"], op, x, p["ox"], p.get("beta", 0.0),
                                               y0, p.get("oy"), p.get("okr"),
                                               p.get("power", 1)))
    return {"full": full(out), "comms": comms}


def k_entry_engine(p):
    """local_copy / local_permute / local_contraction / parallel.copy on
    sharded operands."""
    from superbblas_tpu_torch.ops.contract import local_contraction
    from superbblas_tpu_torch.ops.copy import local_copy, local_permute

    fn = p["fn"]
    if fn == "permute":
        out, comms = _comms(lambda: local_permute(_operand(p, "x"), p["o0"], p["o1"]))
    elif fn == "contraction":
        x0, x1 = _operand(p, "x0"), _operand(p, "x1")
        out, comms = _comms(lambda: local_contraction(
            p["alpha"], x0, p["o0"], p.get("conj0", False), x1, p["o1"], p.get("conj1", False),
            0.0, None, p["o_r"]))
    else:
        x, y = _operand(p, "x"), _operand(p, "y")
        call = local_copy if fn == "copy" else par.copy
        out, comms = _comms(lambda: call(p["alpha"], x, p["o0"], y, p["o1"],
                                         from0=p.get("from0"), size0=p.get("size0"),
                                         from1=p.get("from1"),
                                         copy_add=p.get("copy_add", "copy"),
                                         mask0=p.get("mask0"), mask1=p.get("mask1")))
    from torch.distributed.tensor import DTensor

    a = out.re if cplx.is_carray(out) else out
    return {"full": full(out), "comms": comms,
            "placements": str(a.placements) if isinstance(a, DTensor) else ""}


# ---------------------------------------------------------------------------
# storage


def k_storage(p):
    from superbblas_tpu_torch import storage as S

    m = mesh(*p["mesh"])
    x = shard(p["x"], m, p["spec"])
    cx = isinstance(p["x"], tuple)
    dtype = np.complex128 if cx else np.float64
    sto = S.create_storage_sharded(p["path"], p["order"], p["dim"], dtype=dtype,
                                   checksum=p.get("checksum", 0))
    if p.get("async"):
        S.save_sharded_async(sto, x, p["order"]).result()
    else:
        S.save_sharded(sto, x, p["order"])
        if p.get("twice"):
            S.save_sharded(sto, x, p["order"])
    S.close_storage_sharded(sto)
    out = {}
    for name, path in (("own", p["path"]), ("jax", p.get("jax_path"))):
        if path is None:
            continue
        sto = S.open_storage(path, mode="r")
        S.check_or_write_checksums(sto)
        m2 = mesh(*p["mesh2"])
        back = S.load_sharded(sto, par.NamedSharding(m2, par.PartitionSpec(*p["spec2"])))
        out[name + "_local"] = local(back)
        out[name + "_full"] = full(back)
        S.close_storage(sto)
    return out


def k_consistency(p):
    from superbblas_tpu_torch.utils.testing import check_collective_consistency

    import torch.distributed as dist

    check_collective_consistency("sbt:test:agree", ("decision", True))
    try:
        check_collective_consistency("sbt:test:diverge", ("decision", dist.get_rank() == 0))
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    return {"raised": raised}


# ---------------------------------------------------------------------------
# mesh / multihost


def k_mesh(p):
    m = mesh(*p["mesh"])
    sh = par.NamedSharding(m, par.PartitionSpec(*p["spec"]))
    x = shard(p["x"], m, p["spec"])
    got = par.sharding_partition(x, p["x"].shape)
    return {"ranks": m.mesh.numpy(), "names": tuple(m.mesh_dim_names),
            "boxes": got.boxes, "spec_boxes": tuple(sh.boxes(p["x"].shape)),
            "local": local(x)}


def k_multihost(p):
    import torch.distributed as dist

    par.initialize_distributed(device="cpu")      # idempotent: the group is up
    os.environ["LOCAL_WORLD_SIZE"] = str(p["per_host"])
    try:
        m = par.make_multihost_mesh(p["axes"], dcn_axis=p.get("dcn_axis"))
    finally:
        os.environ.pop("LOCAL_WORLD_SIZE", None)
    v = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(v)
    name = list(p["axes"])[0]
    x = shard(p["x"], m, (name,) + (None,) * (p["x"].ndim - 1))
    ext = par.exchange_halos(x, m, par.PartitionSpec(name, *([None] * (p["x"].ndim - 1))),
                             {0: 1})
    return {"ranks": m.mesh.numpy(), "sum": float(v), "halo": local(ext)}


KINDS = {k[2:]: v for k, v in globals().items() if k.startswith("k_")}


def main():
    suite, case_dir, rank, world, port = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=timedelta(seconds=120))
    case_dir = Path(case_dir)
    cases = pickle.load(open(case_dir / "cases.pkl", "rb"))
    out = {}
    for name, kind, params in cases:
        try:
            out[name] = KINDS[kind](params)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        with open(case_dir / f"out_rank{rank}.pkl.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(case_dir / f"out_rank{rank}.pkl.tmp", case_dir / f"out_rank{rank}.pkl")
    dist.destroy_process_group()
    print(f"{suite} rank {rank}: {len(out)} cases", flush=True)


if __name__ == "__main__":
    main()
