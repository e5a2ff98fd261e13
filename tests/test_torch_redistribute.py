"""superbblas_tpu_torch.parallel.redistribute against superbblas_tpu's.

The plans are host code: every ``RedistributionPlan`` field (pieces,
block, counts, ``counts_elems``, ``pair_cap``, ``send_starts``,
``recv_starts``, the dense layout, ``recv_inverse``, ``aligned``,
``nbytes``) is compared in-process, on the partition pairs of
tests/test_redistribute.py.  The exchanges run on ONE gloo group of 4
processes for the file (tests/_torch_dist_worker.py): each rank's block
of ``redistribute_explicit`` (both methods, both packings, masks,
permutations, alpha and dtype conversion, add) and ``redistribute_auto``
(DTensor path, plan path, stacked form, on master) equals, exactly, the
JAX package's on 4 devices of the virtual CPU mesh, and the SBT_DEBUG=2
replay catches a corrupted plan on every rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_dist import run_group
from superbblas_tpu import parallel as jpar
from superbblas_tpu.parallel import redistribute as JR
from superbblas_tpu_torch import parallel as tpar
from superbblas_tpu_torch.parallel import redistribute as TR

N = 4


def jmesh():
    return Mesh(np.asarray(jax.devices()[:N]), axis_names=("p",))


def jput(stack):
    return jax.device_put(jnp.asarray(stack),
                          NamedSharding(jmesh(), P("p", *([None] * (stack.ndim - 1)))))


def rand_boxes(rng, dim, n=N):
    return tuple((tuple(int(rng.integers(0, d)) for d in dim),
                  tuple(int(rng.integers(1, d + 1)) for d in dim)) for _ in range(n))


def covering(rng, dim, n=N):
    """An uneven slab covering of ``dim``, shifted toroidally."""
    cuts = sorted(rng.choice(np.arange(1, dim[0]), size=n - 1, replace=False))
    starts = [0] + [int(c) for c in cuts]
    sizes = [(starts[i + 1] if i + 1 < n else dim[0]) - starts[i] for i in range(n)]
    shift = int(rng.integers(0, dim[0]))
    return tuple((((s + shift) % dim[0],) + (0,) * (len(dim) - 1), (sz,) + tuple(dim[1:]))
                 for s, sz in zip(starts, sizes))


def PP(dim, boxes):
    """(dim, boxes) as the worker takes them."""
    return (tuple(dim), tuple(boxes))


def jpart(p):
    return jpar.Partition(dim=p[0], boxes=p[1])


def tpart(p):
    return tpar.Partition(dim=p[0], boxes=p[1])


def bp(order, dim, procs, **kw):
    q = jpar.basic_partitioning(order, dim, procs, **kw)
    return PP(q.dim, q.boxes)


# ---------------------------------------------------------------------------
# host-side plans, in-process


def _plan_pairs():
    rng = np.random.default_rng(11)
    out = {
        "grid": (bp("xy", (8, 8), (4, 1)), bp("xy", (8, 8), (2, 2))),
        "uneven": (bp("xy", (10, 3), (4, 1)), bp("xy", (10, 3), (1, 1), nprocs=4)),
        "replicated": (bp("xy", (8, 4), (1, 1), nprocs=4, replicate=True),
                       bp("xy", (8, 4), (2, 2))),
        "halo": (bp("x", (16,), (4,)), bp("x", (16,), (4,), ext_power=(1,))),
        "components": (bp("xy", (8, 6), (4, 1)), bp("xy", (8, 6), (2, 2))),
    }
    for i in range(3):
        dim = (8, 6)
        out[f"fuzz{i}"] = (PP(dim, covering(rng, dim)), PP(dim, rand_boxes(rng, dim)))
    dim = (8, 6, 4)
    out["perm"] = (PP(dim, rand_boxes(rng, dim)),
                   PP((4, 8, 6), rand_boxes(rng, (4, 8, 6))))
    return out


PLAN_PAIRS = _plan_pairs()


def _plan_variants():
    rng = np.random.default_rng(5)
    v = []
    for name in PLAN_PAIRS:
        perm = (2, 0, 1) if name == "perm" else None
        for mode in ("copy", "add"):
            v.append((name, mode, "boxes", None, perm))
            if perm is None:
                v.append((name, mode, "runs", None, perm))
    m0 = rng.random((8, 6)) < 0.6
    m1 = rng.random((8, 6)) < 0.6
    for pck in ("boxes", "runs"):
        v.append(("fuzz0", "copy", pck, (m0, m1), None))
        v.append(("fuzz1", "add", pck, (m0, m1), None))
    return v


PLAN_VARIANTS = _plan_variants()


def _fields(plan):
    inv_d, inv_r = plan.recv_inverse(True), plan.recv_inverse(False)
    pack, unpack = plan.dense_idx()
    return {
        "pieces": {k: np.asarray(v) for k, v in plan.pair_pieces.items()},
        "block": plan.block, "counts": plan.counts, "counts_elems": plan.counts_elems,
        "pair_cap": plan.pair_cap, "pack": plan.pack, "mask_mult": plan.mask_mult,
        "send_starts": plan.send_starts, "recv_starts": plan.recv_starts,
        "aligned": plan.aligned, "dense_pack": pack, "dense_unpack": unpack,
        "inv_dense": inv_d, "inv_ragged": inv_r, "src_shape": plan.src_shape,
        "dst_shape": plan.dst_shape, "nbytes": plan.nbytes,
    }


@pytest.mark.parametrize("case", range(len(PLAN_VARIANTS)),
                         ids=[f"{n}-{m}-{p}-{'mask' if k else 'nomask'}"
                              for n, m, p, k, _ in PLAN_VARIANTS])
def test_plan_fields_match_jax(case):
    name, mode, pck, masks, perm = PLAN_VARIANTS[case]
    src, dst = PLAN_PAIRS[name]
    ms, md = masks if masks is not None else (None, None)
    jp = JR.RedistributionPlan(jpart(src), jpart(dst), mode, pack=pck, mask_src=ms,
                               mask_dst=md, perm=perm)
    tp = TR.RedistributionPlan(tpart(src), tpart(dst), mode, pack=pck, mask_src=ms,
                               mask_dst=md, perm=perm)
    jf, tf = _fields(jp), _fields(tp)
    assert jf["pieces"].keys() == tf["pieces"].keys()
    for k in jf["pieces"]:
        np.testing.assert_array_equal(tf["pieces"][k], jf["pieces"][k])
        assert tf["pieces"][k].dtype == jf["pieces"][k].dtype
    for key in jf:
        if key == "pieces":
            continue
        a, b = tf[key], jf[key]
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


def test_may_need_communications_matches_jax():
    for src, dst in PLAN_PAIRS.values():
        if src[0] != dst[0]:
            continue
        assert (TR.may_need_communications(tpart(src), tpart(dst))
                == JR.may_need_communications(jpart(src), jpart(dst)))
    same = bp("xy", (8, 8), (2, 2))
    assert not TR.may_need_communications(tpart(same), tpart(same))


def test_plan_cache_budget_and_guards(monkeypatch):
    """The byte-budget LRU (SBT_CACHEGB) evicts as JAX's does; the plan's
    named errors match."""
    from superbblas_tpu import flags as jflags
    from superbblas_tpu_torch import flags as tflags

    pairs = list(PLAN_PAIRS.values())[:4]
    for cache in (JR._PlanCache(maxsize=2), TR._PlanCache(maxsize=2)):
        mk = jpart if isinstance(cache, JR._PlanCache) else tpart
        for src, dst in pairs:
            cache(mk(src), mk(dst))
        cache(mk(pairs[-1][0]), mk(pairs[-1][1]))
        info = cache.cache_info()
        assert (info.hits, info.misses, info.currsize) == (1, 4, 2)
    monkeypatch.setenv("SBT_CACHEGB", "0")
    tflags.clear_cache()
    jflags.clear_cache()
    try:
        c = TR._PlanCache()
        for src, dst in pairs:
            c(tpart(src), tpart(dst))
        assert c.cache_info().currsize == 1
    finally:
        monkeypatch.delenv("SBT_CACHEGB")
        tflags.clear_cache()
        jflags.clear_cache()
    src, dst = PLAN_PAIRS["perm"]
    with pytest.raises(ValueError, match="'boxes' packer"):
        TR.RedistributionPlan(tpart(src), tpart(dst), pack="runs", perm=(2, 0, 1))
    bad = tpar.Partition(dim=(4,), boxes=(((0,), (4,)), ((1,), (2,))))
    one = tpar.Partition(dim=(4,), boxes=(((0,), (4,)), ((0,), (0,))))
    with pytest.raises(ValueError, match="same number of procs"):
        TR.RedistributionPlan(bad, tpar.Partition(dim=(4,), boxes=(((0,), (4,)),)))
    assert TR.RedistributionPlan(bad, one).counts_elems.sum() == 4


def test_pack_unpack_global_match_jax():
    rng = np.random.default_rng(3)
    for src, dst in PLAN_PAIRS.values():
        x = rng.standard_normal(src[0])
        np.testing.assert_array_equal(TR.pack_global(x, tpart(src)),
                                      JR.pack_global(x, jpart(src)))
        st = JR.pack_global(x, jpart(src))
        np.testing.assert_array_equal(TR.unpack_global(st, tpart(src)),
                                      JR.unpack_global(st, jpart(src)))


# ---------------------------------------------------------------------------
# exchanges on one gloo group of 4 processes


def _group_cases():
    rng = np.random.default_rng(2024)
    cases = []

    def add(name, **p):
        cases.append((name, "explicit", p))

    dim = (8, 8, 4)
    src, dst = bp("xyz", dim, (4, 1, 1)), bp("xyz", dim, (2, 2, 1))
    x = rng.standard_normal(dim).astype(np.float32)
    for method in ("ragged", "dense"):
        for pack in ("boxes", "runs"):
            add(f"grid-{method}-{pack}", src=src, dst=dst, x=x, method=method, pack=pack)
    d2 = (10, 6)
    x2 = rng.standard_normal(d2)
    for method in ("ragged", "dense"):
        add(f"uneven-{method}", src=bp("xy", d2, (4, 1)),
            dst=bp("xy", d2, (3, 1), nprocs=4), x=x2, method=method)
    add("halo-ext", src=bp("x", (16,), (4,)), dst=bp("x", (16,), (4,), ext_power=(1,)),
        x=np.arange(16, dtype=np.float32))
    d3 = (8, 6)
    for i in range(2):
        s3, t3 = PP(d3, covering(rng, d3)), PP(d3, rand_boxes(rng, d3))
        xi = rng.integers(-8, 8, d3).astype(np.float64)   # exact sums in any order
        for mode, method, pack in (("copy", "ragged", "boxes"), ("add", "dense", "runs"),
                                   ("copy", "dense", "runs"), ("add", "ragged", "boxes")):
            add(f"fuzz{i}-{mode}-{method}-{pack}", src=s3, dst=t3, x=xi, copy_add=mode,
                method=method, pack=pack)
    s4, t4 = PP(d3, rand_boxes(rng, d3)), PP(d3, rand_boxes(rng, d3))
    m0, m1 = rng.random(d3) < 0.7, rng.random(d3) < 0.7
    xm = rng.integers(-8, 8, d3).astype(np.float64)
    for pack in ("boxes", "runs"):
        for mode in ("copy", "add"):
            add(f"masked-{pack}-{mode}", src=s4, dst=t4, x=xm, copy_add=mode, pack=pack,
                mask_src=m0, mask_dst=m1, method="dense" if mode == "add" else "ragged")
    full, empty = ((0,), (4,)), ((0,), (0,))
    ms = np.zeros((N, 4), dtype=bool)
    ms[0] = [False, True, False, True]
    ms[1] = True
    for pack in ("boxes", "runs"):
        add(f"stacked-mask-{pack}", src=PP((4,), (full, full, empty, empty)),
            dst=PP((4,), (full, empty, empty, empty)), x=np.arange(1.0, 5.0), pack=pack,
            mask_src=ms)
    d5 = (8, 6, 4)
    perm = (2, 0, 1)
    dd5 = tuple(d5[p] for p in perm)
    s5, t5 = PP(d5, rand_boxes(rng, d5)), PP(dd5, rand_boxes(rng, dd5))
    x5 = rng.integers(-8, 8, d5).astype(np.float32)
    for mode, method in (("copy", "ragged"), ("add", "dense")):
        add(f"perm-alpha-f64-{mode}-{method}", src=s5, dst=t5, x=x5, copy_add=mode,
            method=method, perm=perm, alpha=-1.75, out_dtype="float64")
    xc = rng.standard_normal(d3)
    add("complex-alpha", src=s3, dst=t3, x=xc, x_im=rng.standard_normal(d3),
        alpha=0.5 - 2.0j, method="ragged")
    add("replicated-add", src=bp("x", (8,), (1,), nprocs=4, replicate=True),
        dst=bp("x", (8,), (4,)), x=np.ones(8), copy_add="add")
    add("debug-replay-ok", src=src, dst=dst, x=x, debug=2)
    cases.append(("debug-replay-corrupt", "replay_corrupt",
                  dict(src=bp("xy", (8, 8), (2, 2)), dst=bp("xy", (8, 8), (1, 4)),
                       x=np.arange(64, dtype=np.float32).reshape(8, 8))))

    # redistribute_auto: global DTensor in, DTensor (or on master) out
    da = (8, 8)
    xa = rng.standard_normal(da)
    ga, gb = bp("xy", da, (4, 1)), bp("xy", da, (2, 2))

    def auto(name, **p):
        cases.append((name, "auto", p))

    half = (((0, 0), (4, 8)),) * 2 + (((4, 0), (4, 8)),) * 2
    auto("auto-grid", src=PP(da, half), dst=gb, x=xa, order="xy",
         x_mesh=((2, 2), ("x", "y")), x_spec=("x", None))
    # x's rows split over both mesh axes, [Shard(0), Shard(0)]: the boxes of ga
    auto("auto-two-axes", src=ga, dst=gb, x=xa, order="xy",
         x_mesh=((2, 2), ("x", "y")), x_spec=(("x", "y"), None))
    auto("auto-uneven", src=ga, dst=bp("xy", da, (3, 1), nprocs=4), x=xa, order="xy",
         x_mesh=((4,), ("x",)), x_spec=("x", None))
    auto("auto-on-master", src=ga, dst=bp("xy", da, (1, 1), nprocs=4), x=xa, order="xy",
         x_mesh=((4,), ("x",)), x_spec=("x", None))
    auto("auto-plain-add", src=bp("xy", da, (1, 1), nprocs=4, replicate=True), dst=gb,
         x=np.ones(da), order="xy", copy_add="add")
    auto("auto-partial-src", src=PP((4, 4), (((0, 0), (2, 4)),) + (((0, 0), (0, 0)),) * 3),
         dst=bp("xy", (4, 4), (1, 1), nprocs=4, replicate=True),
         x=np.arange(16.0).reshape(4, 4), order="xy")
    auto("auto-order-dst", src=ga, dst=bp("yx", da, (2, 1), nprocs=4), x=xa, order="xy",
         order_dst="yx", alpha=3.0, out_dtype="float32", x_mesh=((4,), ("x",)),
         x_spec=("x", None))
    auto("auto-stacked", src=ga, dst=gb, x=JR.pack_global(xa, jpart(ga)), order="xy")
    return cases


CASES = _group_cases()


def _jax_expected(name, kind, p):
    if kind == "explicit":
        src, dst = jpart(p["src"]), jpart(p["dst"])
        stack = JR.pack_global(p["x"], src)
        from superbblas_tpu import cplx as jcplx

        st = jput(stack)
        if p.get("x_im") is not None:
            st = jcplx.CArray(st, jput(JR.pack_global(p["x_im"], src)))
        plan = JR.RedistributionPlan(src, dst, p.get("copy_add", "copy"), pack=p.get("pack"),
                                     mask_src=p.get("mask_src"), mask_dst=p.get("mask_dst"),
                                     perm=p.get("perm"))
        alpha = p.get("alpha")
        if alpha is not None and isinstance(alpha, complex):
            st = jcplx.scale(alpha, st)
            alpha = None
        method = p.get("method", "auto")
        method = "ragged" if method == "auto" else method
        odt = getattr(np, p["out_dtype"]) if p.get("out_dtype") else None
        out = JR._execute(plan, st, jmesh(), "p", method, alpha=alpha, out_dtype=odt)
        parts = (tuple(np.asarray(a) for a in out) if isinstance(out, jcplx.CArray)
                 else np.asarray(out))
        return {"out": parts, "pack": plan.pack}
    if name == "auto-partial-src":
        # host oracle: JAX's entry cannot place a replicated result on a
        # 4-device subset of the 8-device virtual mesh
        want = np.asarray(p["x"]).copy()
        want[2:] = 0.0
        return {"full": want}
    if kind == "auto":
        src, dst = jpart(p["src"]), jpart(p["dst"])
        odt = getattr(np, p["out_dtype"]) if p.get("out_dtype") else None
        if name == "auto-stacked":
            out = JR.redistribute_auto(jput(p["x"]), src, dst, mesh=jmesh())
            return {"full": JR.unpack_global(np.asarray(out), dst)}
        out = JR.redistribute_auto(jnp.asarray(p["x"]), src, dst, order=p["order"],
                                   mesh=jmesh(), copy_add=p.get("copy_add", "copy"),
                                   order_dst=p.get("order_dst"), alpha=p.get("alpha"),
                                   out_dtype=odt)
        return {"full": np.asarray(out)}
    return {}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group("redistribute", CASES, tmp_path_factory.mktemp("redistribute"))


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[1] == "explicit"])
def test_explicit_matches_jax_exactly(group, name):
    kind, p = next((k, p) for n, k, p in CASES if n == name)
    want = _jax_expected(name, kind, p)
    for r, got in enumerate(group.case(name)):
        assert got["pack"] == want["pack"]
        w = want["out"]
        if isinstance(w, tuple):
            for g, ww in zip(got["out"], w):
                np.testing.assert_array_equal(g, ww[r], err_msg=f"rank {r}")
        else:
            assert got["dtype"] == f"torch.{w.dtype}"
            np.testing.assert_array_equal(got["out"], w[r], err_msg=f"rank {r}")


def test_debug_replay_catches_a_corrupt_plan_on_every_rank(group):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    dst = jpart(bp("xy", (8, 8), (1, 4)))
    for r, got in enumerate(group.case("debug-replay-corrupt")):
        np.testing.assert_array_equal(got["ok"], JR.pack_global(x, dst)[r])
        assert got["corrupted"]
        assert "debug replay mismatch" in got["raised"]


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[1] == "auto"])
def test_auto_matches_jax(group, name):
    kind, p = next((k, p) for n, k, p in CASES if n == name)
    want = _jax_expected(name, kind, p)["full"]
    outs = group.case(name)
    if name == "auto-on-master":
        np.testing.assert_array_equal(outs[0]["full"], want)
        assert all(o["full"].size == 0 for o in outs[1:])
        return
    if name == "auto-stacked":
        got = TR.unpack_global(outs[0]["full"], tpart(p["dst"]))
        np.testing.assert_array_equal(got, want)
        return
    nonempty = [r for r, b in enumerate(p["dst"][1]) if np.prod(b[1])]
    for r, o in enumerate(outs):
        if name == "auto-order-dst" and r not in nonempty:
            assert o["full"].size == 0       # outside the destination's 2-rank mesh
            continue
        assert o["dtensor"]
        np.testing.assert_array_equal(o["full"], want)
    if name == "auto-grid":   # the DTensor path: one redistribute on x's own mesh
        assert outs[0]["placements"] == "(Shard(dim=0), Shard(dim=1))"
