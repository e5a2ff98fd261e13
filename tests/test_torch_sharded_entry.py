"""The port's ordinary entry points on sharded operands, against the JAX
package's unsharded results.

The JAX package computes on sharded ``jax.Array``s through its ordinary
functions (``tests/test_wilson.py::test_sharded_wilson_matches_single_device``
applies the AoS Wilson operator to a field sharded on ("x", "y", "n")).
The port's ``apply_wilson``, the family applies, ``cg_solve``,
``eo_solve``, ``eo_solve_packed_soa``, ``bsr_krylov`` (gather mode,
powers with ``okr``, an SoA operator in the AoS order), ``local_copy``,
``local_permute``, ``local_contraction`` and ``parallel.copy`` across label
sets take DTensors on one gloo group of 4 processes.  The JAX side
computes the unsharded result (its AoS operators on the same links; the
SoA fields are the AoS ones transposed), at f64 to rtol 1e-10.  Where the
port's sharded and plain calls take the same kernel route (K1's plain
version on the halo-extended block) the shard equals the plain call's bit
for bit.  A sharded apply makes one ``all_to_all_single`` per sharded
lattice axis with a radius, none for column shards, and no all-gather.
The even-odd masks and the packed parity are checked on ranks whose
shard, or halo-extended block, starts at an odd site."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_group
from superbblas_tpu import bsr as B
from superbblas_tpu import cplx as jcplx
from superbblas_tpu.models import clover as JC
from superbblas_tpu.models import domain_wall as JD
from superbblas_tpu.models import eo_packed as JEP
from superbblas_tpu.models import even_odd as JEO
from superbblas_tpu.models import staggered as JS
from superbblas_tpu.models import wilson as JW
from superbblas_tpu.ops.contract import local_contraction as j_contraction
from superbblas_tpu.ops.copy import local_copy as j_copy, local_permute as j_permute
from test_torch_overlap_powers import gather_params, stencil_params

LAT = (4, 4, 2, 2)
XY = ((2, 2), ("X", "Y"))
XN = ((2, 2), ("X", "N"))
N = 2
A2A = "c10d.alltoall_base_"


def links(lat, seed):
    return JW.random_su3_links(np.random.default_rng(seed), lat)


def cfield(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def pair(z):
    return (np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag))


def aos_to_soa(z):
    """AoS [*lat, S, C, n] (or [*lat, C, n]) -> SoA [n, S*C, *lat]."""
    nl = 4
    f = z.reshape(z.shape[:nl] + (-1, z.shape[-1]))
    return np.ascontiguousarray(np.moveaxis(np.moveaxis(f, -1, 0), -1, 1))


def soa_to_aos(z, inner):
    """SoA [n, F, *lat] -> AoS [*lat, *inner, n]."""
    lat = z.shape[2:]
    return np.moveaxis(np.moveaxis(z, 1, -1), 0, -1).reshape(lat + tuple(inner) + (z.shape[0],))


def dw_aos(z):
    """Moebius SoA [n, Ls, 12, *lat] -> AoS [Ls, *lat, 4, 3, n]."""
    n, ls = z.shape[:2]
    lat = z.shape[3:]
    return np.transpose(z.reshape((n, ls, 4, 3) + lat), (1, 4, 5, 6, 7, 2, 3, 0))


FAMILY = {
    "wilson": dict(family="wilson", mass=0.3),
    "twisted": dict(family="twisted", mass=0.2, mu=0.15),
    "clover": dict(family="clover", mass=0.25, c_sw=1.1),
    "staggered": dict(family="staggered", mass=0.3),
    "mobius": dict(family="mobius", Ls=4, M5=1.6, m_f=0.1, b5=1.4, c5=0.4),
}


def jfamily(p):
    """The JAX package's AoS operator of ``p`` and its apply."""
    f, lat = p["family"], tuple(p["lat"])
    kw = dict(links=p["links"], dtype=jnp.complex128, layout="aos")
    if f == "wilson":
        return JW.wilson_operator(lat, mass=p["mass"], **kw), JW.apply_wilson
    if f == "twisted":
        return JW.twisted_mass_operator(lat, mass=p["mass"], mu=p["mu"], **kw), JW.apply_wilson
    if f == "clover":
        return JC.wilson_clover_operator(lat, mass=p["mass"], c_sw=p["c_sw"], **kw), \
            JC.apply_clover
    if f == "staggered":
        return JS.staggered_operator(lat, mass=p["mass"], **kw), JS.apply_staggered
    return JD.mobius_operator(lat, Ls=p["Ls"], M5=p["M5"], m_f=p["m_f"], b5=p["b5"],
                              c5=p["c5"], **kw), JD.apply_domain_wall


def apply_case(fam, layout, mesh, spec, blocks_spec=None, lat=LAT, seed=0):
    p = dict(FAMILY[fam], layout=layout, lat=lat, links=links(lat, 10 + seed), mesh=mesh,
             spec=spec, blocks_spec=blocks_spec)
    if fam == "mobius":
        shape = (N, p["Ls"], 12) + lat
    elif layout == "aos":
        shape = lat + ((3,) if fam == "staggered" else (4, 3)) + (N,)
    else:
        shape = (N, 3 if fam == "staggered" else 12) + lat
    p["x"] = pair(cfield(shape, 20 + seed))
    return p


def _lat_spec(names, lead=2, tail=0):
    return (None,) * lead + tuple(names) + (None,) * (4 - len(names)) + (None,) * tail


APPLY = {
    # F1's case: the AoS Wilson operator, x and the blocks sharded
    "f1-aos-xy": apply_case("wilson", "aos", ((2, 2), ("x", "y")),
                            ("x", "y", None, None, None, None, None),
                            ("x", "y", None, None, None, None, None)),
    "f1-aos-x-cols": apply_case("wilson", "aos", ((2, 2), ("x", "n")),
                                ("x", None, None, None, None, None, "n"),
                                ("x", None, None, None, None, None, None)),
    "soa-wilson-xy": apply_case("wilson", "soa", XY, _lat_spec(("X", "Y"))),
    "soa-wilson-x-cols": apply_case("wilson", "soa", XN, ("N", None, "X", None, None, None),
                                    blocks_spec=(None, None, "X", None, None, None), seed=1),
    "soa-wilson-cols": apply_case("wilson", "soa", ((2, 2), ("N", "M")),
                                  ("N", None, None, None, None, None), seed=2),
    "soa-twisted-xy": apply_case("twisted", "soa", XY, _lat_spec(("X", "Y")), seed=3),
    "soa-clover-x-cols": apply_case("clover", "soa", XN, ("N", None, "X", None, None, None),
                                    seed=4),
    "soa-staggered-xy": apply_case("staggered", "soa", XY, _lat_spec(("X", "Y")), seed=5),
    "soa-mobius-x-cols": apply_case("mobius", "soa", XN,
                                    ("N", None, None, "X", None, None, None), seed=6),
    "soa-mobius-xy": apply_case("mobius", "soa", XY,
                                (None, None, None, "X", "Y", None, None), seed=7),
}
#: all_to_all_single calls of one apply: one per sharded lattice axis
#: with a radius (the clover term has none, columns need none)
EXCHANGES = {"f1-aos-xy": 2, "f1-aos-x-cols": 1, "soa-wilson-xy": 2, "soa-wilson-x-cols": 1,
             "soa-wilson-cols": 0, "soa-twisted-xy": 2, "soa-clover-x-cols": 1,
             "soa-staggered-xy": 2, "soa-mobius-x-cols": 1, "soa-mobius-xy": 2}


def _solve_cases():
    c = []
    p = dict(FAMILY["wilson"], layout="soa", lat=LAT, links=links(LAT, 30), mesh=XY,
             spec=_lat_spec(("X", "Y")), blocks_spec=_lat_spec(("X", "Y")), fn="cg", iters=5)
    p["b"] = pair(aos_to_soa(cfield(LAT + (4, 3, N), 31)))
    c.append(("cg-solve", "entry_solve", p))
    lat = (4, 6, 2, 2)   # Y over 2: rank (., 1)'s shard starts at the odd y = 3
    p = dict(FAMILY["wilson"], layout="soa", lat=lat, links=links(lat, 32), mesh=XY,
             spec=_lat_spec(("X", "Y")), fn="eo_packed", iters=4, a=0.3 + 4)
    p["b"] = pair(aos_to_soa(cfield(lat + (4, 3, N), 33)))
    c.append(("eo-packed-solve", "entry_solve", p))
    lat = (4, 6, 2, 2)   # the AoS packed solve: K3-free kron packing, odd y origin
    p = dict(FAMILY["wilson"], layout="aos", lat=lat, links=links(lat, 38), mesh=XY,
             spec=("X", "Y", None, None, None, None, None), fn="eo_packed_aos", iters=4,
             a=0.3 + 4)
    p["b"] = pair(cfield(lat + (4, 3, N), 39))
    c.append(("eo-packed-aos-solve", "entry_solve", p))
    lat = (6, 4, 2, 2)   # X over 2: rank 1's shard starts at the odd x = 3
    p = dict(FAMILY["wilson"], layout="aos", lat=lat, links=links(lat, 34),
             mesh=((2, 2), ("x", "n")), spec=("x", None, None, None, None, None, "n"),
             fn="eo_masked", iters=4, a=0.3 + 4)
    p["b"] = pair(cfield(lat + (4, 3, N), 35))
    c.append(("eo-masked-solve", "entry_solve", p))
    lat = (4, 6, 2, 2)
    p = dict(FAMILY["wilson"], layout="soa", lat=lat, links=links(lat, 36), mesh=XY,
             spec=_lat_spec(("X", "Y")))
    p["x"] = pair(aos_to_soa(cfield(lat + (4, 3, N), 37)))
    c.append(("packed", "entry_packed", p))
    return c


def _krylov_cases():
    rng = np.random.default_rng(40)
    c = []
    gp = gather_params((16, 4, 6), 2, 9)[1]
    xg = (rng.standard_normal((16, 4, 6, 2, 4)), rng.standard_normal((16, 4, 6, 2, 4)))
    c.append(("krylov-gather", "entry_krylov", dict(
        gp, mesh=((2, 2), ("X", "N")), x=xg, spec=("X", None, None, None, "N"), ox="xyzcn",
        alpha=2.0)))
    c.append(("krylov-okr", "entry_krylov", dict(
        stencil_params((16, 8), 2, 2, 3), mesh=XY, x=rng.standard_normal((16, 8, 2, 4)),
        spec=("X", None, None, "Y"), ox="XYsn", alpha=1.5, power=2, okr="q")))
    c.append(("krylov-okr-gather", "entry_krylov", dict(
        gp, mesh=((4,), ("X",)), x=xg, spec=("X", None, None, None, None), ox="xyzcn",
        alpha=1.0, power=2, okr="p")))
    p = dict(FAMILY["wilson"], op="family", layout="soa", lat=LAT, links=links(LAT, 41),
             mesh=XN, x=pair(cfield(LAT + (4, 3, N), 42)),
             spec=("X", None, None, None, None, None, "N"), ox="xyztSCn", alpha=0.5,
             y=pair(cfield(LAT + (4, 3, N), 43)),
             y_spec=("X", None, None, None, None, None, "N"), beta=2.0)
    c.append(("krylov-soa-aos-order", "entry_krylov", p))
    return c


def _engine_cases():
    rng = np.random.default_rng(50)
    c = []
    x = (rng.standard_normal((8, 4, 4, 3)), rng.standard_normal((8, 4, 4, 3)))
    y = (rng.standard_normal((4, 4, 3, 8)), rng.standard_normal((4, 4, 3, 8)))
    base = dict(mesh=XY)
    c.append(("copy-box", "entry_engine", dict(
        base, fn="copy", alpha=2.0, x=x, x_spec=("X", None, "Y", None), y=y,
        y_spec=(None, "Y", None, "X"), o0="xyzs", o1="yzsx", from0=(1, 0, 1, 0),
        size0=(6, 4, 2, 3), from1=(0, 1, 0, 2), copy_add="add")))
    c.append(("permute", "entry_engine", dict(
        base, fn="permute", x=x, x_spec=("X", "Y", None, None), o0="xyzs", o1="szxy")))
    a0 = rng.standard_normal((8, 4, 3))
    a1 = rng.standard_normal((3, 4, 5))
    c.append(("contraction", "entry_engine", dict(
        base, fn="contraction", alpha=1.5, x0=a0, x0_spec=("X", "Y", None), x1=a1,
        x1_spec=(None, "Y", None), o0="xyc", o1="cyn", o_r="xn")))
    # a spin component sliced into a field without spin, and the reverse
    f = (rng.standard_normal((8, 4, 4, 2)), rng.standard_normal((8, 4, 4, 2)))
    g = (rng.standard_normal((8, 4, 2)), rng.standard_normal((8, 4, 2)))
    c.append(("labels-slice", "entry_engine", dict(
        base, fn="dist_copy", alpha=1.0, x=f, x_spec=("X", "Y", None, None), y=g,
        y_spec=("X", None, "Y"), o0="xysn", o1="xyn", from0=(0, 0, 2, 0),
        size0=(8, 4, 1, 2))))
    c.append(("labels-insert", "entry_engine", dict(
        base, fn="dist_copy", alpha=-1.0, x=g, x_spec=(None, "Y", "X"), y=f,
        y_spec=("X", "Y", None, None), o0="xyn", o1="xysn", from1=(0, 0, 3, 0))))
    m0 = rng.random((8, 4, 4, 2)) < 0.5
    m1 = np.zeros((8, 4, 2), bool)
    m1.reshape(-1)[rng.permutation(m1.size)[:int(m0[:, :, 1:2].sum())]] = True
    c.append(("labels-masked", "entry_engine", dict(
        base, fn="dist_copy", alpha=1.0, x=f, x_spec=("X", "Y", None, None), y=g,
        y_spec=("Y", None, "X"), o0="xysn", o1="xyn", from0=(0, 0, 1, 0),
        size0=(8, 4, 1, 2), mask0=m0, mask1=m1)))
    c.append(("copy-labels-entry", "entry_engine", dict(
        base, fn="copy", alpha=1.0, x=g, x_spec=("X", None, None), y=f,
        y_spec=(None, "Y", None, "X"), o0="xyn", o1="xysn", from1=(0, 0, 1, 0))))
    return c


CASES = ([(n, "entry_apply", p) for n, p in APPLY.items()] + _solve_cases() + _krylov_cases()
         + _engine_cases())
PARAMS = {n: p for n, _, p in CASES}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group("sharded_entry", CASES, tmp_path_factory.mktemp("sharded_entry"))


def _c(v):
    return v[0] + 1j * v[1] if isinstance(v, tuple) else v


def close(got, want, rtol=1e-10):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _shard_of(full, r, mesh, spec):
    shape, names = mesh
    coord = np.unravel_index(r, shape)
    sl = []
    for d, nm in zip(full.shape, spec):
        if nm is None:
            sl.append(slice(None))
        else:
            n = shape[names.index(nm)]
            c = coord[names.index(nm)]
            sl.append(slice(c * d // n, (c + 1) * d // n))
    return full[tuple(sl)]


def _want_apply(p):
    op, apply = jfamily(p)
    x = _c(p["x"])
    if p["layout"] == "aos":
        return np.asarray(apply(op, jnp.asarray(x)))
    if p["family"] == "mobius":
        got = np.asarray(apply(op, jnp.asarray(dw_aos(x))))
        n, ls = x.shape[:2]
        lat = x.shape[3:]
        return np.transpose(got, (7, 0, 5, 6, 1, 2, 3, 4)).reshape((n, ls, 12) + lat)
    inner = (3,) if p["family"] == "staggered" else (4, 3)
    return aos_to_soa(np.asarray(apply(op, jnp.asarray(soa_to_aos(x, inner)))))


@pytest.mark.parametrize("name", list(APPLY))
def test_sharded_apply_matches_jax_unsharded(group, name):
    p = PARAMS[name]
    want = _want_apply(p)
    for r, got in enumerate(group.case(name)):
        close(_c(got["full"]), want)
        if p["layout"] == "soa":
            # the same K1 route (its plain version) on the halo-extended
            # block as on the whole lattice: this rank's shard bit for bit
            mine = _shard_of(_c(got["plain"]), r, p["mesh"], p["spec"])
            np.testing.assert_array_equal(_c(got["local"]), mine)


@pytest.mark.parametrize("name", list(APPLY))
def test_sharded_apply_collectives(group, name):
    for got in group.case(name):
        comms = got["comms"]
        assert comms.get(A2A, 0) == EXCHANGES[name], comms
        assert not [k for k in comms if "gather" in k], comms
        assert set(comms) <= {A2A}, comms


def test_f1_case_is_sharded_as_its_input(group):
    for got in group.case("f1-aos-xy"):
        assert got["placements"] == "(Shard(dim=0), Shard(dim=1))"
    for got in group.case("f1-aos-x-cols"):
        assert got["placements"] == "(Shard(dim=0), Shard(dim=6))"


def test_cg_solve_matches_jax(group):
    p = PARAMS["cg-solve"]
    jop, _ = jfamily(p)
    b = soa_to_aos(_c(p["b"]), (4, 3))
    x, rs = JW.cg_solve(jop, jnp.asarray(b), n_iters=p["iters"])
    want = aos_to_soa(np.asarray(x))
    for got in group.case("cg-solve"):
        close(_c(got["full"]), want)
        np.testing.assert_allclose(got["rs"], float(rs), rtol=1e-10)
        close(_c(got["plain"]), want)
        assert got["comms"].get(A2A, 0) > 0 and not [k for k in got["comms"] if "gather" in k]


def test_eo_solve_packed_soa_matches_jax(group):
    p = PARAMS["eo-packed-solve"]
    jop, _ = jfamily(p)
    b = soa_to_aos(_c(p["b"]), (4, 3))
    jb = jcplx.CArray(jnp.asarray(b.real), jnp.asarray(b.imag))
    psi, rs = JEP.eo_solve_packed(jop, jb, p["a"], n_iters=p["iters"])
    want = aos_to_soa(np.asarray(psi.re) + 1j * np.asarray(psi.im))
    for got in group.case("eo-packed-solve"):
        close(_c(got["full"]), want)
        np.testing.assert_allclose(got["rs"], float(rs), rtol=1e-10)
        close(_c(got["plain"]), want)


def test_eo_solve_packed_aos_matches_jax(group):
    p = PARAMS["eo-packed-aos-solve"]
    jop, _ = jfamily(p)
    b = _c(p["b"])
    jb = jcplx.CArray(jnp.asarray(b.real), jnp.asarray(b.imag))
    psi, rs = JEP.eo_solve_packed(jop, jb, p["a"], n_iters=p["iters"])
    want = np.asarray(psi.re) + 1j * np.asarray(psi.im)
    for got in group.case("eo-packed-aos-solve"):
        close(_c(got["full"]), want)
        np.testing.assert_allclose(got["rs"], float(rs), rtol=1e-10)
        close(_c(got["plain"]), want)
        assert not [k for k in got["comms"] if "gather" in k], got["comms"]


def test_eo_solve_masks_on_an_odd_origin(group):
    p = PARAMS["eo-masked-solve"]
    jop, _ = jfamily(p)
    psi, rs = JEO.eo_solve(jop, jnp.asarray(_c(p["b"])), p["a"], n_iters=p["iters"])
    lat = p["lat"]
    par = np.indices(lat).sum(0) % 2
    origins = set()
    for r, got in enumerate(group.case("eo-masked-solve")):
        close(_c(got["full"]), np.asarray(psi))
        np.testing.assert_allclose(got["rs"], float(rs), rtol=1e-10)
        o = got["origin"][:4]
        origins.add(o[0])
        loc = got["mask"].reshape(got["mask"].shape[:4])
        want = (par[o[0]:o[0] + loc.shape[0]] == 0).astype(np.float32)
        np.testing.assert_array_equal(loc, want)
    assert 3 in origins        # a shard starting at an odd x


def test_packed_parity_on_an_odd_origin(group):
    p = PARAMS["packed"]
    x = _c(p["x"])
    origins = set()
    for r, got in enumerate(group.case("packed")):
        origins.add(got["origin"][3])
        for par_ in (0, 1):
            want = JEP.cb_pack_soa(jcplx.CArray(jnp.asarray(x.real), jnp.asarray(x.imag)),
                                   par_)
            np.testing.assert_array_equal(_c(got[f"pack{par_}"]),
                                          np.asarray(want.re) + 1j * np.asarray(want.im))
            # K1's packed route on the halo'd block (which starts at an odd y on
            # every rank of the first Y row: y = -1) gives the plain call's bits
            spec = p["spec"]
            mine = _shard_of(_c(got[f"hop{par_}_plain"]), r, p["mesh"], spec)
            np.testing.assert_array_equal(_c(got[f"hop{par_}"]), mine)
            assert got[f"comms{par_}"].get(A2A, 0) == 2
        np.testing.assert_array_equal(_c(got["unpack"]), x)
    assert 3 in origins        # a shard starting at an odd y


def _want_krylov(name, p):
    if p["op"] == "family":
        jop = jfamily(dict(p, layout="aos"))[0]
        x, y = _c(p["x"]), _c(p["y"])
        return p["alpha"] * np.asarray(JW.apply_wilson(jop, jnp.asarray(x))) + p["beta"] * y
    if p["op"] == "stencil":
        lat = "XY"[:len(p["dim"])]
        jop = B.bsr_from_stencil(lat + "s", lat + "s", p["dim"], {"s": p["BI"]},
                                 {"s": p["BD"]}, p["offs"], jnp.asarray(p["vals"]))
    else:
        jop = B.create_bsr(*(list(p["args"]) + [jnp.asarray(p["vals"])]))
    x = p["x"]
    x = jcplx.CArray(jnp.asarray(x[0]), jnp.asarray(x[1])) if isinstance(x, tuple) \
        else jnp.asarray(x)
    out = B.bsr_krylov(p["alpha"], jop, x, p["ox"], okr=p.get("okr"),
                       power=p.get("power", 1))
    return np.asarray(out.re) + 1j * np.asarray(out.im) if isinstance(out, jcplx.CArray) \
        else np.asarray(out)


@pytest.mark.parametrize("name", [n for n, k, _ in CASES if k == "entry_krylov"])
def test_bsr_krylov_on_sharded_operands_matches_jax(group, name):
    p = PARAMS[name]
    want = _want_krylov(name, p)
    for got in group.case(name):
        close(_c(got["full"]), want)
        assert not [k for k in got["comms"] if "gather" in k], got["comms"]


def _want_engine(p):
    fn = p["fn"]
    cx = lambda v: jcplx.CArray(jnp.asarray(v[0]), jnp.asarray(v[1])) \
        if isinstance(v, tuple) else jnp.asarray(v)  # noqa: E731
    if fn == "permute":
        out = j_permute(cx(p["x"]), p["o0"], p["o1"])
    elif fn == "contraction":
        out = j_contraction(p["alpha"], cx(p["x0"]), p["o0"], False, cx(p["x1"]), p["o1"],
                            False, 0.0, None, p["o_r"])
    else:
        out = j_copy(p["alpha"], cx(p["x"]), p["o0"], cx(p["y"]), p["o1"],
                     from0=p.get("from0"), size0=p.get("size0"), from1=p.get("from1"),
                     copy_add=p.get("copy_add", "copy"), mask0=p.get("mask0"),
                     mask1=p.get("mask1"))
    return np.asarray(out.re) + 1j * np.asarray(out.im) if isinstance(out, jcplx.CArray) \
        else np.asarray(out)


@pytest.mark.parametrize("name", [n for n, k, _ in CASES if k == "entry_engine"])
def test_label_engine_on_sharded_operands_matches_jax(group, name):
    p = PARAMS[name]
    want = _want_engine(p)
    for got in group.case(name):
        close(_c(got["full"]), want, rtol=1e-12)
        assert got["placements"], "the result is a DTensor"
        if p["fn"] == "permute":
            assert got["comms"] == {}
