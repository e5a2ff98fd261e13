"""superbblas_tpu_torch.parallel.gather_sharded against superbblas_tpu's.

The halo plans are host code: ``make_gather_halo_plan`` gives the JAX
package's frame widths and local index tables exactly (one and two
sharded axes, CA powers, spin factors, its errors), compared in-process
on the irregular operators of tests/test_gather_sharded.py.  One gloo
group of 4 processes runs ``apply_gather_sharded`` (power 1, CA power 3,
``all_powers``, two sharded axes, spin factors) and
``apply_gather_overlap`` (with ``just_local``, and through
``bsr_krylov_overlap``) on the port's gather mode (E1/K3's plain
versions on the CPU), against the JAX package's sharded function on 4
devices for one case and its own oracle (``bsr_krylov`` on the whole
lattice) for the rest; f64 to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_dist import run_group
from superbblas_tpu import bsr as B
from superbblas_tpu import cplx as jcplx
from superbblas_tpu.parallel import apply_gather_sharded as j_apply
from superbblas_tpu.parallel import make_gather_halo_plan as j_plan
from superbblas_tpu_torch import bsr as TB
from superbblas_tpu_torch.parallel import make_gather_halo_plan as t_plan
from test_gather_sharded import _irregular_op


def irregular(dim, nc, seed, kron=False, reach=1):
    """_irregular_op's JAX operator, and the port's from the same numbers."""
    rng = np.random.default_rng(seed)
    captured = {}
    name = "create_kron_bsr" if kron else "create_bsr"
    orig = getattr(B, name)

    def spy(*args):
        captured["args"] = args
        return orig(*args)

    setattr(B, name, spy)
    try:
        op = _irregular_op(dim, nc, 0, reach, rng, kron=kron)
    finally:
        setattr(B, name, orig)
    a = captured["args"]
    if kron:
        return op, dict(op="gather", args=a[:10], vals=np.asarray(a[10]),
                        kr=np.asarray(a[11]), nd=len(dim))
    return op, dict(op="gather", args=a[:8], vals=np.asarray(a[8]), nd=len(dim))


def tport(p):
    if p.get("kr") is not None:
        return TB.create_kron_bsr(*p["args"], torch_t(p["vals"]), torch_t(p["kr"]),
                                  device="cpu")
    return TB.create_bsr(*p["args"], torch_t(p["vals"]), device="cpu")


def torch_t(a):
    import torch

    return torch.from_numpy(np.array(a))       # a writable copy


PLAN_CASES = [("1axis", (16, 4, 6), False, 0, 1, 4, 1), ("1axis-p2", (16, 4, 6), False, 0, 1,
                                                       4, 2),
              ("1axis-p3-kron", (16, 4, 6), True, 0, 1, 4, 3),
              ("2axes", (8, 8, 6), False, (0, 1), 1, (2, 2), 1),
              ("2axes-p2", (8, 8, 6), False, (0, 1), 1, (2, 2), 2)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_halo_plan_matches_jax(case):
    _, dim, kron, ax, reach, ns, power = case
    jop, p = irregular(dim, 2, 21, kron=kron, reach=reach)
    top = tport(p)
    wj, jjj = j_plan(jop, ax, ns, power=power)
    wt, jjt = t_plan(top, ax, ns, power=power)
    assert wt == wj
    assert jjt.dtype == jjj.dtype
    np.testing.assert_array_equal(jjt, jjj)


def test_halo_plan_errors_match_jax():
    jop, p = irregular((16, 4, 4), 2, 3, reach=7)
    top = tport(p)
    for fn, op in ((j_plan, jop), (t_plan, top)):
        with pytest.raises(ValueError, match="planes past"):
            fn(op, 0, 8)
        with pytest.raises(ValueError, match="power must be >= 1"):
            fn(op, 0, 2, power=0)
        with pytest.raises(ValueError, match="must divide"):
            fn(op, 0, 3)


def _cases():
    rng = np.random.default_rng(0)
    c = []
    _, p1 = irregular((16, 4, 6), 2, 41)
    x1 = (rng.standard_normal((16, 4, 6, 2, 3)), rng.standard_normal((16, 4, 6, 2, 3)))
    base = dict(p1, mesh=((4,), ("d",)), x=x1, x_spec=("d", None, None, None, None),
                axes={"x": "d", "y": None, "z": None})
    c.append(("sharded-p1", "gather", dict(base)))
    c.append(("sharded-p3", "gather", dict(base, power=3)))
    c.append(("sharded-all-powers", "gather", dict(base, power=2, all_powers=True)))
    c.append(("overlap", "gather", dict(base, overlap=True)))
    c.append(("overlap-just-local", "gather", dict(base, overlap=True, just_local=True)))
    c.append(("overlap-krylov", "overlap", dict(base, ox="xyzcn", alpha=2.0)))
    _, pk = irregular((16, 4, 4), 2, 7, kron=True)
    xk = (rng.standard_normal((16, 4, 4, 2, 2, 3)), rng.standard_normal((16, 4, 4, 2, 2, 3)))
    c.append(("sharded-kron", "gather", dict(pk, mesh=((4,), ("d",)), x=xk,
                                             x_spec=("d",) + (None,) * 5,
                                             axes={"x": "d"})))
    c.append(("overlap-kron-2axes", "gather", dict(
        irregular((8, 8, 4), 2, 8, kron=True)[1], mesh=((2, 2), ("a", "b")),
        x=(rng.standard_normal((8, 8, 4, 2, 2, 2)), rng.standard_normal((8, 8, 4, 2, 2, 2))),
        x_spec=("a", "b") + (None,) * 4, axes={"x": "a", "y": "b"}, overlap=True)))
    _, p2 = irregular((8, 8, 6), 2, 21)
    x2 = (rng.standard_normal((8, 8, 6, 2, 3)), rng.standard_normal((8, 8, 6, 2, 3)))
    for power in (1, 2):
        c.append((f"2axes-p{power}", "gather", dict(
            p2, mesh=((2, 2), ("a", "b")), x=x2, x_spec=("a", "b", None, None, None),
            axes={"x": "a", "y": "b", "z": None}, power=power)))
    return c


CASES = _cases()
JOPS = {}


def _jop(name, p):
    if name not in JOPS:
        args = list(p["args"]) + [jnp.asarray(p["vals"])]
        if p.get("kr") is not None:
            JOPS[name] = B.create_kron_bsr(*args, jnp.asarray(p["kr"]))
        else:
            JOPS[name] = B.create_bsr(*args)
    return JOPS[name]


def _np(v):
    if isinstance(v, jcplx.CArray):
        return np.asarray(v.re) + 1j * np.asarray(v.im)
    return v[0] + 1j * v[1] if isinstance(v, tuple) else np.asarray(v)


def _expected(name, p):
    op = _jop(name, p)
    x = jcplx.CArray(jnp.asarray(p["x"][0]), jnp.asarray(p["x"][1]))
    nd = p["nd"]
    ox = "xyz"[:nd] + ("Ccn" if p.get("kr") is not None else "cn")
    if name == "sharded-p1":        # the JAX package's sharded gather itself
        m = Mesh(np.asarray(jax.devices()[:4]), ("d",))
        xs = jax.device_put(x, NamedSharding(m, P(*p["x_spec"])))
        return _np(j_apply(op, xs, m, p["axes"]))
    if name == "overlap-just-local":
        # zero every slot whose neighbour leaves the owner's slab along x
        dim = tuple(p["args"][1][:nd])
        L = dim[0] // 4
        jj = np.asarray(op.jj_flat).reshape(dim + (-1,))
        vloc = np.asarray(op.blocks).copy()
        crossing = (np.unravel_index(jj, dim)[0] // L) != \
            (np.arange(dim[0]) // L)[:, None, None, None]
        vloc[crossing] = 0.0
        op_loc = B.create_bsr("xyzs", dim + (2,), "xyzc", dim + (2,), (1, 1, 1, 2),
                              (1, 1, 1, 2), np.full(dim, jj.shape[-1], np.int64),
                              np.stack(np.unravel_index(jj, dim), axis=-1), jnp.asarray(vloc))
        return _np(B.bsr_krylov(1.0, op_loc, x, ox))
    if name == "overlap-krylov":
        return _np(B.bsr_krylov(2.0, op, x, ox))
    outs, cur = [], x
    for _ in range(p.get("power", 1)):
        cur = B.bsr_krylov(1.0, op, cur, ox)
        outs.append(_np(cur))
    return np.stack(outs) if p.get("all_powers") else outs[-1]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group("gather_sharded", CASES, tmp_path_factory.mktemp("gather_sharded"))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_matches_jax(group, name):
    p = next(c[2] for c in CASES if c[0] == name)
    want = _expected(name, p)
    for r, got in enumerate(group.case(name)):
        g = _np(got["full"])
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, rtol=1e-12, atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"rank {r}")
