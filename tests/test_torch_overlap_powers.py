"""superbblas_tpu_torch.parallel.overlap (``bsr_krylov_overlap``) and
.powers (``bsr_krylov_ca``) against superbblas_tpu's, on one gloo group
of 4 processes over a 2x2 mesh (and one axis of 4).

The cases of tests/test_overlap.py and tests/test_powers.py: the
core/halo overlap on AoS stencil operators (with beta*y, on the Wilson
kron operator, and ``just_local`` against the zero-boundary oracle), the
communication-avoiding powers (all axes or one sharded, the Wilson kron
operator, gather mode through the halo-plan executor, the unsharded
fallback), and the halo-width error.  The JAX side runs ``bsr_krylov``
(its own oracle for both paths) and, for one case of each, the JAX
package's sharded function on 4 devices; f64 to 1e-12."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_dist import run_group
from superbblas_tpu import bsr as B
from superbblas_tpu import cplx as jcplx
from superbblas_tpu.models import wilson_operator
from superbblas_tpu.parallel.overlap import bsr_krylov_overlap as j_overlap
from superbblas_tpu.parallel.powers import bsr_krylov_ca as j_ca
from test_bsr import stencil_offsets
from test_gather_sharded import _irregular_op

XY = ((2, 2), ("X", "Y"))


def jmesh(m):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(m[0]), m[1])


def stencil_params(dim, BI, BD, seed):
    offs = stencil_offsets(dim)
    vals = np.random.default_rng(seed).standard_normal(tuple(dim) + (len(offs), BI, BD))
    return dict(op="stencil", dim=dim, BI=BI, BD=BD, offs=offs, vals=vals)


def gather_params(dim, nc, seed):
    """The inputs of test_gather_sharded._irregular_op, kept to build the
    port's operator from the same numbers."""
    rng = np.random.default_rng(seed)
    captured = {}
    orig = B.create_bsr

    def spy(*args):
        captured["args"] = args
        return orig(*args)

    B.create_bsr = spy
    try:
        op = _irregular_op(dim, nc, 0, 1, rng)
    finally:
        B.create_bsr = orig
    a = captured["args"]
    return op, dict(op="gather", args=a[:8], vals=np.asarray(a[8]))


def _cases():
    rng = np.random.default_rng(0)
    c = []
    c.append(("overlap-plain", "overlap", dict(
        stencil_params((16, 8), 3, 2, 4), mesh=XY, x=rng.standard_normal((16, 8, 2, 5)),
        x_spec=("X", "Y", None, None), ox="XYsn", axes={"X": "X", "Y": "Y"}, alpha=1.5)))
    c.append(("overlap-beta", "overlap", dict(
        stencil_params((8, 8), 2, 2, 9), mesh=XY, x=rng.standard_normal((8, 8, 2, 3)),
        x_spec=("X", "Y", None, None), y=rng.standard_normal((8, 8, 2, 3)),
        ox="XYsn", axes={"X": "X", "Y": "Y"}, alpha=2.0, beta=-1.0)))
    c.append(("overlap-just-local", "overlap", dict(
        stencil_params((16, 8), 2, 2, 7), mesh=((4, 1), ("X", "Y")),
        x=rng.standard_normal((16, 8, 2, 3)), x_spec=("X", None, None, None), ox="XYsn",
        axes={"X": "X"}, alpha=1.0, just_local=True)))
    lat = (8, 8, 2, 2)
    xw = (rng.standard_normal(lat + (4, 3, 2)), rng.standard_normal(lat + (4, 3, 2)))
    c.append(("overlap-wilson", "overlap", dict(
        op="wilson", layout="aos", lat=lat, mass=0.2, key=1, mesh=XY, x=xw,
        x_spec=("X", "Y") + (None,) * 5, ox="xyztSCn", axes={"x": "X", "y": "Y"},
        alpha=1.0)))
    c.append(("ca-power3", "powers", dict(
        stencil_params((16, 8), 3, 3, 5), mesh=((4, 1), ("X", "Y")),
        x=rng.standard_normal((16, 8, 3, 5)), x_spec=("X", None, None, None), ox="XYsn",
        axes={"X": "X", "Y": "Y"}, alpha=2.0, power=3)))
    c.append(("ca-partial", "powers", dict(
        stencil_params((16, 8), 2, 2, 3), mesh=XY, x=rng.standard_normal((16, 8, 2, 4)),
        x_spec=("X", None, None, None), ox="XYsn", axes={"X": "X"}, alpha=1.0, power=2,
        okr="q")))
    c.append(("ca-wilson", "powers", dict(
        op="wilson", layout="aos", lat=lat, mass=0.3, key=2, mesh=XY, x=xw,
        x_spec=("X", "Y") + (None,) * 5, ox="xyztSCn", axes={"x": "X", "y": "Y"},
        alpha=1.0, power=2, okr="k")))
    gop, gp = gather_params((16, 4, 6), 2, 9)
    xg = (rng.standard_normal((16, 4, 6, 2, 3)), rng.standard_normal((16, 4, 6, 2, 3)))
    c.append(("ca-gather", "powers", dict(
        gp, mesh=((4,), ("X",)), x=xg, x_spec=("X", None, None, None, None), ox="xyzcn",
        axes={"x": "X"}, alpha=2.0, power=2)))
    c.append(("ca-gather-unsharded", "powers", dict(
        gp, mesh=((4,), ("X",)), x=xg, ox="xyzcn", axes={}, alpha=2.0, power=2)))
    c.append(("ca-width-raises", "raises", dict(
        stencil_params((16, 8), 2, 2, 0), mesh=XY, x=np.ones((16, 8, 2, 1)),
        x_spec=("X", "Y", None, None), fn="powers", ox="XYsn", axes={"X": "X", "Y": "Y"},
        power=5)))
    return c, gop


CASES, GATHER_OP = _cases()


def _jop(p):
    if p["op"] == "stencil":
        lat = "XY"[:len(p["dim"])]
        return B.bsr_from_stencil(lat + "s", lat + "s", p["dim"], {"s": p["BI"]},
                                  {"s": p["BD"]}, p["offs"], jnp.asarray(p["vals"]))
    if p["op"] == "wilson":
        return wilson_operator(p["lat"], mass=p["mass"], key=p["key"], dtype=jnp.complex128)
    return GATHER_OP


def _jx(v):
    return jcplx.CArray(jnp.asarray(v[0]), jnp.asarray(v[1])) if isinstance(v, tuple) \
        else jnp.asarray(v)


def _np(v):
    if isinstance(v, jcplx.CArray):
        return np.asarray(v.re) + 1j * np.asarray(v.im)
    if isinstance(v, tuple):
        return v[0] + 1j * v[1]
    return np.asarray(v)


def _just_local_oracle(p):
    dim, offs, vals = p["dim"], p["offs"], p["vals"]
    sh = dim[0] // 4          # X over 4 ranks; Y unsharded wraps locally
    y = np.zeros(tuple(dim) + (vals.shape[-2], p["x"].shape[-1]))
    for site in itertools.product(*[range(d) for d in dim]):
        for k, off in enumerate(offs):
            nb = tuple((s + o) % d for s, o, d in zip(site, off, dim))
            s0, o0 = site[0], off[0]
            cross = (s0 + o0 < (s0 // sh) * sh) or (s0 + o0 >= (s0 // sh + 1) * sh)
            if not cross:
                y[site] += vals[site][k] @ p["x"][nb]
    return y


def _expected(name, p):
    op = _jop(p)
    x = _jx(p["x"])
    if name == "overlap-just-local":
        return _just_local_oracle(p)
    if name == "overlap-plain":     # the JAX package's sharded overlap itself
        m = jmesh(p["mesh"])
        xs = jax.device_put(x, NamedSharding(m, P(*p["x_spec"])))
        return _np(j_overlap(p["alpha"], op, xs, p["ox"], m, p["axes"]))
    if name == "ca-power3":         # the JAX package's CA powers itself
        m = jmesh(p["mesh"])
        xs = jax.device_put(x, NamedSharding(m, P(*p["x_spec"])))
        return _np(j_ca(p["alpha"], op, xs, p["ox"], m, p["axes"], power=p["power"]))
    if name.startswith("overlap"):
        y = _jx(p["y"]) if p.get("y") is not None else None
        return _np(B.bsr_krylov(p["alpha"], op, x, p["ox"], beta=p.get("beta", 0.0), y=y))
    return _np(B.bsr_krylov(p["alpha"], op, x, p["ox"], okr=p.get("okr", "p"),
                            power=p["power"]))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group("overlap_powers", CASES, tmp_path_factory.mktemp("overlap_powers"))


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[1] != "raises"])
def test_matches_jax(group, name):
    p = next(c[2] for c in CASES if c[0] == name)
    want = _expected(name, p)
    for r, got in enumerate(group.case(name)):
        g = _np(got["full"])
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, rtol=1e-12, atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"rank {r}")


def test_halo_width_raises_as_jax(group):
    for got in group.case("ca-width-raises"):
        assert got["raised"].startswith("ValueError: halo width 5 exceeds local extent 4")
