"""superbblas_tpu_torch.parallel.dist (copy, contraction, reshard) and the
sharded operands of superbblas_tpu_torch.dense against superbblas_tpu.

One gloo group of 4 processes runs every case of the file
(tests/_torch_dist_worker.py) on DTensors over a 2x2 mesh; the JAX
package runs the same call on 4 devices of the virtual CPU mesh.  Copies
(box copies that wrap, permute, add; masked; replicated into sharded and
back) and reshards that only move data are exact; copies that scale or
add, contractions (sharded contracted labels, mixed distributions,
conjugation, alpha/beta) and dense ops hold f64 to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_dist import run_group
from superbblas_tpu import cplx as jcplx
from superbblas_tpu import dense as jdense
from superbblas_tpu import parallel as jpar

XY = ((2, 2), ("x", "y"))
TX = ((2, 2), ("t", "x"))


def jm(mesh):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(mesh[0]), mesh[1])


def rnd(shape, seed, cplx_=False):
    rng = np.random.default_rng(seed)
    if cplx_:
        return (rng.standard_normal(shape), rng.standard_normal(shape))
    return rng.standard_normal(shape)


def jval(v, mesh, spec):
    a = (jnp.asarray(v[0]) + 1j * jnp.asarray(v[1])) if isinstance(v, tuple) \
        else jnp.asarray(v)
    if spec is None:
        return a
    return jax.device_put(a, NamedSharding(jm(mesh), P(*spec)))


def npval(out):
    if isinstance(out, jcplx.CArray):
        return np.asarray(out.re) + 1j * np.asarray(out.im)
    return np.asarray(out)


def _cases():
    c = []
    m0 = (np.add.outer(np.arange(8), np.arange(8)) % 2) == 0
    c.append(("copy-perm-box-add", "copy", dict(
        mesh=XY, x=rnd((8, 8, 4), 1), x_spec=("x", "y", None), y=rnd((4, 8, 8), 2),
        y_spec=(None, "y", "x"), alpha=2.0, o0="xyt", o1="tyx", from0=(1, 2, 0),
        size0=(4, 4, 4), from1=(0, 1, 3), copy_add="add")))
    c.append(("copy-wrap", "copy", dict(
        mesh=XY, x=rnd((8, 8), 3), x_spec=("x", "y"), y=rnd((8, 8), 4), y_spec=("x", "y"),
        alpha=1.0, o0="xy", o1="xy", from0=(6, 6), size0=(4, 4), from1=(7, 0))))
    c.append(("copy-masked", "copy", dict(
        mesh=XY, x=rnd((8, 8), 31), x_spec=("x", "y"), y=rnd((8, 8), 32),
        y_spec=("x", "y"), alpha=2.0, o0="xy", o1="xy", mask0=m0, mask1=m0)))
    c.append(("copy-masked-pairing", "copy", dict(
        mesh=XY, x=rnd((8, 8), 33), x_spec=("x", None), y=rnd((8, 8), 34),
        y_spec=(None, "y"), alpha=-1.0, o0="xy", o1="yx", mask0=m0, mask1=np.roll(m0, 1, 0),
        copy_add="add")))
    c.append(("copy-complex-alpha", "copy", dict(
        mesh=XY, x=rnd((8, 6), 35, True), x_spec=("x", None), y=rnd((8, 6), 36, True),
        y_spec=(None, "y"), alpha=0.5 + 1.5j, o0="xy", o1="xy", from0=(3, 1),
        size0=(6, 4), from1=(5, 4))))
    c.append(("copy-replicated-into-sharded", "copy", dict(
        mesh=XY, x=rnd((8, 8), 5), y=rnd((8, 8), 6), y_spec=("y", "x"), alpha=1.0,
        o0="xy", o1="yx")))
    c.append(("copy-sharded-into-replicated", "copy", dict(
        mesh=XY, x=rnd((8, 8), 7), x_spec=("x", "y"), y=rnd((8, 8), 8), alpha=3.0,
        o0="xy", o1="xy", copy_add="add")))
    for d0, d1 in (("everyone", "everyone"), ("everyone", "replicated"),
                   ("replicated", "everyone")):
        sp = {"everyone": ("t", "x", None), "replicated": None}
        c.append((f"contraction-{d0}-{d1}", "contraction", dict(
            mesh=TX, x0=rnd((8, 8, 6), 5, True), x0_spec=sp[d0], o0="tab",
            x1=rnd((8, 8, 4), 6, True), x1_spec=sp[d1], o1="tac", conj1=True,
            alpha=1.5 + 0.5j, beta=-0.5, r=rnd((8, 6, 4), 7, True), r_spec=("t", None, None),
            o_r="tbc")))
    rng = np.random.default_rng(42)
    specs = {"t": ("t", None, None), "mid": (None, "x", None), "repl": None,
             "tx": ("t", "x", None)}
    for case in range(6):
        k0, k1 = rng.choice(list(specs), size=2)
        beta = [0.0, complex(rng.standard_normal(), rng.standard_normal())][case % 2]
        c.append((f"contraction-sweep{case}-{k0}-{k1}", "contraction", dict(
            mesh=TX, x0=rnd((8, 4, 6), 100 + case, True), x0_spec=specs[k0], o0="tab",
            conj0=bool(case % 3 == 0), x1=rnd((8, 4, 4), 200 + case, True),
            x1_spec=specs[k1], o1="tac", conj1=bool(case % 2), beta=beta,
            alpha=complex(rng.standard_normal(), rng.standard_normal()),
            r=rnd((8, 6, 4), 300 + case, True), r_spec=("t", None, None), o_r="tbc")))
    c.append(("contraction-real-contracted-sharded", "contraction", dict(
        mesh=XY, x0=rnd((8, 6), 9), x0_spec=("x", "y"), o0="ab", x1=rnd((8, 4), 10),
        x1_spec=("x", None), o1="ac", alpha=1.0, o_r="bc")))
    c.append(("reshard-same-mesh", "reshard", dict(
        mesh=XY, x=rnd((8, 8), 8), x_spec=("x", None), to_mesh=XY, to_spec=(None, "y"))))
    c.append(("reshard-other-mesh", "reshard", dict(
        mesh=XY, x=rnd((8, 8), 11), x_spec=("x", "y"), to_mesh=((4,), ("p",)),
        to_spec=(None, "p"))))
    c.append(("reshard-plain", "reshard", dict(
        mesh=XY, x=rnd((8, 6), 12), to_mesh=XY, to_spec=("y", "x"))))
    # dense ops: batch label t sharded, matrix labels whole
    rngd = np.random.default_rng(7)
    a = rngd.standard_normal((8, 4, 4)) + 1j * rngd.standard_normal((8, 4, 4))
    hpd = np.einsum("tij,tkj->tik", a, a.conj()) + 4 * np.eye(4)
    xr = rngd.standard_normal((8, 4, 3)) + 1j * rngd.standard_normal((8, 4, 3))
    split = lambda v: (v.real.copy(), v.imag.copy())  # noqa: E731
    for fn in ("cholesky", "inversion"):
        c.append((f"dense-{fn}", "dense", dict(mesh=TX, fn=fn, a=split(hpd),
                                               a_spec=("t", None, None), oa="tij",
                                               orows="i", ocols="j")))
    for fn in ("gesm", "trsm"):
        mat = np.triu(hpd) if fn == "trsm" else hpd
        c.append((f"dense-{fn}", "dense", dict(
            mesh=TX, fn=fn, alpha=2.0, a=split(mat), a_spec=("t", None, None), oa="tij",
            orows="i", ocols="j", x=split(xr), x_spec=("t", None, None), ox="tin",
            oy="tjn")))
    c.append(("dense-sharded-matrix-label-raises", "dense", dict(
        mesh=TX, fn="cholesky", a=split(hpd), a_spec=(None, "x", None), oa="tij", orows="i",
        ocols="j")))
    return c


CASES = _cases()


def _jax_expected(name, kind, p):
    mesh = p["mesh"]
    if kind == "copy":
        out = jpar.copy(p["alpha"], jval(p["x"], mesh, p.get("x_spec")), p["o0"],
                        jval(p["y"], mesh, p.get("y_spec")), p["o1"], from0=p.get("from0"),
                        size0=p.get("size0"), from1=p.get("from1"),
                        copy_add=p.get("copy_add", "copy"), mask0=p.get("mask0"),
                        mask1=p.get("mask1"))
        return npval(out)
    if kind == "contraction":
        r = jval(p["r"], mesh, p.get("r_spec")) if p.get("r") is not None else None
        out = jpar.contraction(p["alpha"], jval(p["x0"], mesh, p.get("x0_spec")), p["o0"],
                               p.get("conj0", False), jval(p["x1"], mesh, p.get("x1_spec")),
                               p["o1"], p.get("conj1", False), p.get("beta", 0.0), r,
                               p["o_r"])
        return npval(out)
    if kind == "reshard":
        return np.asarray(p["x"])
    if kind == "dense":
        a = jcplx.CArray(jnp.asarray(p["a"][0]), jnp.asarray(p["a"][1]))
        if p["fn"] in ("cholesky", "inversion"):
            return npval(getattr(jdense, p["fn"])(a, p["oa"], p["orows"], p["ocols"]))
        x = jcplx.CArray(jnp.asarray(p["x"][0]), jnp.asarray(p["x"][1]))
        return npval(getattr(jdense, p["fn"])(p["alpha"], a, p["oa"], p["orows"], p["ocols"],
                                              x, p["ox"], p["oy"]))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    # SBT_DEBUG=2: every distributed copy is verified with mock indices and
    # every redistribution it makes replayed through the exchange
    return run_group("dist", CASES, tmp_path_factory.mktemp("dist"), env={"SBT_DEBUG": "2"})


def _np(got):
    return got[0] + 1j * got[1] if isinstance(got, tuple) else got


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_matches_jax(group, name):
    kind, p = next((k, p) for n, k, p in CASES if n == name)
    outs = group.case(name)
    if name.endswith("raises"):
        for o in outs:
            assert "matrix label 'i' is sharded" in o["raised"]
        return
    want = _jax_expected(name, kind, p)
    for r, o in enumerate(outs):
        got = _np(o["full"])
        exact = kind == "reshard" or (kind == "copy" and p["alpha"] == 1.0
                                       and p.get("copy_add", "copy") == "copy")
        if exact:      # pure data movement
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max(),
                                       err_msg=f"rank {r}")
    if kind == "reshard":
        assert outs[0]["placements"] in ("(Replicate(), Shard(dim=1))", "(Shard(dim=1),)",
                                         "(Shard(dim=1), Shard(dim=0))")
    if name == "contraction-everyone-everyone":
        # t survives on its mesh axis; the contracted a was all-reduced away
        assert outs[0]["placements"] == "(Shard(dim=0), Replicate())"
    if kind == "dense":
        assert outs[0]["placements"] == "(Shard(dim=0), Replicate())"
