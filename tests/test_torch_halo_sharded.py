"""superbblas_tpu_torch.parallel.halo and .stencil_sharded against
superbblas_tpu's, and the slice's whole path on a gloo group of 4
processes.

``exchange_halos`` gives each rank the block (core and halo shells) the
JAX package's gives each device, exactly; ``crop_halos`` undoes it.
``apply_stencil_soa_sharded`` (K1's plain version on each rank's
halo-extended block) equals the JAX package's at f64 to 1e-12 and the
port's unsharded apply bit for bit; with ``power`` 2, and sharded on X
alone, it equals the JAX package's unsharded apply (its own oracle for
the sharded path).  The whole path: a
sharded Wilson CG on the normal equations (``solvers.cg`` on DTensors,
its inner products all-reduced) whose residuals and solution equal the
JAX package's unsharded CG at f64 to 1e-12; the solution saved with
``save_sharded`` (one S3T block per rank), reloaded with
``load_sharded`` onto a mesh on Y, moved with ``redistribute_auto`` to an
uneven partition and on master, each bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_dist import run_group
from superbblas_tpu import bsr as jbsr
from superbblas_tpu import cplx as jcplx
from superbblas_tpu import solvers as jsolvers
from superbblas_tpu import storage as jst
from superbblas_tpu.models import wilson as jW
from superbblas_tpu.parallel import apply_stencil_soa_sharded as j_sharded
from superbblas_tpu.parallel import basic_partitioning
from superbblas_tpu.parallel.halo import exchange_halos as j_exchange

XY = ((2, 2), ("X", "Y"))
LAT = (4, 4, 8, 128)     # the JAX package's SoA layout takes Z % 8 == 0, T % 128 == 0
SPEC6 = (None, None, "X", "Y", None, None)
ITERS = (2, 5)
HELD_LAT = (8, 4, 4, 4)  # X split 4 ways: 2 planes a rank, room for power 2's halo


def jmesh(m):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(m[0]), m[1])


def fields(seed, n=2):
    rng = np.random.default_rng(seed)
    shape = (n, 12) + LAT
    return (rng.standard_normal(shape), rng.standard_normal(shape))


HALO_CASES = [
    ("halo-x-1", dict(mesh=((4,), ("p",)), spec=("p",), widths={0: 1},
                      x=np.arange(16, dtype=np.float32))),
    ("halo-2x2-both", dict(mesh=XY, spec=("X", "Y", None), widths={0: 1, 1: 2},
                           x=np.random.default_rng(1).standard_normal((8, 8, 3)))),
    ("halo-2x2-one", dict(mesh=XY, spec=(None, "Y", "X"), widths={2: 2},
                          x=np.random.default_rng(2).standard_normal((3, 8, 8)))),
]


def _cases(tmp):
    c = [(n, "exchange_halos", p) for n, p in HALO_CASES]
    for power in (1, 2):
        c.append((f"stencil-power{power}", "stencil_sharded", dict(
            mesh=XY, lat=LAT, mass=0.2, key=1, spec=SPEC6, axes={"x": "X", "y": "Y"},
            x=fields(0), power=power)))
    c.append(("stencil-x-only", "stencil_sharded", dict(
        mesh=((4,), ("X",)), lat=(8, 2, 8, 128), mass=0.3, key=2,
        spec=(None, None, "X", None, None, None), axes={"x": "X"},
        x=(np.random.default_rng(3).standard_normal((1, 12, 8, 2, 8, 128)),
           np.random.default_rng(4).standard_normal((1, 12, 8, 2, 8, 128))))))
    rng = np.random.default_rng(11)
    c.append(("held-blocks", "held_blocks", dict(
        mesh=((4,), ("X",)), lat=HELD_LAT, mass=0.2, c_sw=1.0, key=3,
        spec=(None, None, "X", None, None, None), axes={"x": "X"},
        xs=[tuple(rng.standard_normal((1, 12) + HELD_LAT) for _ in range(2))
            for _ in range(3)])))
    c.append(("refusal", "refusal", dict(mesh=XY, lat=LAT, mass=0.2, key=1, spec=SPEC6,
                                         x=fields(9, 1))))
    dim = (1, 12) + LAT
    uneven = basic_partitioning("nfxyzt", dim, (1, 1, 1, 1, 3, 1), nprocs=4)
    c.append(("sharded-solve", "sharded_solve", dict(
        mesh=XY, lat=LAT, mass=0.25, key=5, spec=SPEC6, axes={"x": "X", "y": "Y"},
        b=fields(7, 1), iters=ITERS, path=str(tmp / "psi.s3t"), mesh2=((4,), ("P",)),
        spec2=(None, None, None, "P", None, None), uneven=(uneven.dim, uneven.boxes))))
    return c


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo_sharded")
    cases = _cases(tmp)
    return run_group("halo_sharded", cases, tmp), {n: p for n, _, p in cases}


def _np(v):
    return v[0] + 1j * v[1] if isinstance(v, tuple) else v


@pytest.mark.parametrize("name", [c[0] for c in HALO_CASES])
def test_exchange_halos_matches_jax(group, name):
    res, params = group
    p = params[name]
    spec = P(*p["spec"])
    m = jmesh(p["mesh"])
    xj = jax.device_put(jnp.asarray(p["x"]), NamedSharding(m, spec))
    ext = j_exchange(xj, m, spec, p["widths"])
    shards = {s.device.id: np.asarray(s.data) for s in ext.addressable_shards}
    for r, got in enumerate(res.case(name)):
        np.testing.assert_array_equal(got["local"], shards[r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["crop"], got["core"])
        assert got["shape"] == tuple(ext.shape)


def _j_wilson(lat, mass, key):
    return jW.wilson_operator(lat, mass=mass, key=key, dtype=jnp.complex128, layout="soa")


@pytest.mark.parametrize("name", ["stencil-power1", "stencil-power2", "stencil-x-only"])
def test_sharded_soa_apply_matches_jax(group, name):
    res, params = group
    p = params[name]
    op = _j_wilson(p["lat"], p["mass"], p["key"])
    m = jmesh(p["mesh"])
    sh = NamedSharding(m, P(*p["spec"]))
    x = jcplx.CArray(jnp.asarray(p["x"][0]), jnp.asarray(p["x"][1]))
    if name == "stencil-power1":
        op_sh = type(op)(**{**op.__dict__, "blocks": jax.device_put(op.blocks, sh)})
        want = j_sharded(op_sh, jax.device_put(x, sh), m, p["axes"])
    else:
        # the JAX package's own oracle for its sharded path (tests/test_overlap.py):
        # the unsharded apply, power times (a shard_map compile costs ~10 s here)
        want = x
        for _ in range(p.get("power", 1)):
            want = jbsr.apply_stencil_soa(op, want)
    want = np.asarray(want.re) + 1j * np.asarray(want.im)
    for r, got in enumerate(res.case(name)):
        g = _np(got["full"])
        np.testing.assert_allclose(g, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        # the same K1 route as the port's unsharded apply: equal bits on the shard
        np.testing.assert_array_equal(got["local"][0], got["unsharded"][0][
            tuple(_shard_slices(r, p))])


def _shard_slices(r, p):
    shape, names = p["mesh"]
    coord = np.unravel_index(r, shape)
    lat = p["lat"]
    sl = [slice(None), slice(None)]
    for k, name in enumerate(p["spec"][2:]):
        if name is None:
            sl.append(slice(None))
        else:
            n = shape[names.index(name)]
            L = lat[k] // n
            c = coord[names.index(name)]
            sl.append(slice(c * L, (c + 1) * L))
    return sl


def test_sharded_solve_checkpoint_redistribute_matches_jax(group):
    """The slice's path on 4 ranks against the JAX package on one
    device: CG on D^H D, then the checkpoint round trip and the moves."""
    res, params = group
    p = params["sharded-solve"]
    op = _j_wilson(p["lat"], p["mass"], p["key"])
    oph = jW.adjoint_operator(op)
    A = lambda v: jbsr.apply_stencil_soa(oph, jbsr.apply_stencil_soa(op, v))  # noqa: E731
    b = jcplx.CArray(jnp.asarray(p["b"][0]), jnp.asarray(p["b"][1]))
    rhs = jbsr.apply_stencil_soa(oph, b)
    hist = []
    for k in ITERS:
        xj, rs, _ = jsolvers.cg(A, rhs, tol=0.0, maxiter=k)
        hist.append(float(rs))
    want = np.asarray(xj.re) + 1j * np.asarray(xj.im)
    outs = res.case("sharded-solve")
    for r, got in enumerate(outs):
        np.testing.assert_allclose(got["hist"], hist, rtol=1e-12)
        x = _np(got["x"])
        np.testing.assert_allclose(x, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        assert got["blocks"] == 4                     # one S3T block per rank
        np.testing.assert_array_equal(_np(got["reload_full"]), x)
        np.testing.assert_array_equal(_np(got["uneven_full"]), x)
    np.testing.assert_array_equal(_np(outs[0]["master"]), _np(outs[0]["x"]))
    assert all(_np(o["master"]).size == 0 for o in outs[1:])
    # the 4-block file reads back whole in one process (the JAX package's load)
    sto = jst.open_storage(p["path"], mode="r")
    whole = jst.load(1.0, sto, np.zeros((1, 12) + LAT, np.complex128), "nfxyzt")
    jst.close_storage(sto)
    np.testing.assert_array_equal(np.asarray(whole), _np(outs[0]["x"]))


def test_kernel_wrappers_refuse_dtensors_and_inner_products_reduce(group):
    """No hidden gather: a DTensor reaching a kernel wrapper raises and
    names the distributed function, while the ordinary entry point one
    level up (``bsr.apply_stencil_soa``) takes it to the sharded apply;
    the solvers' inner product of sharded fields reads the all-reduced
    value, not the rank's part."""
    res, params = group
    x = params["refusal"]["x"]
    want = float((x[0] ** 2).sum() + (x[1] ** 2).sum())
    hints = {"stencil_matvec_soa": "apply_stencil_soa_sharded",
             "stencil_matvec_soa_rt": "apply_stencil_soa_sharded",
             "batched_small_gemm": "apply_gather_sharded",
             "batched_gemm_rowpack": "apply_gather_sharded",
             "maybe_permute": "parallel.copy", "permute_4d": "parallel.copy",
             "cg_dot": "solvers.cg"}
    for got in res.case("refusal"):
        for name, hint in hints.items():
            assert got[name].startswith(f"{name}: a sharded DTensor operand; use"), name
            assert hint in got[name], name
        assert got["entry"] == "(Shard(dim=2), Shard(dim=3))"
        np.testing.assert_allclose(got["inner"], want, rtol=1e-12)
        assert abs(got["local_inner"] - want) > 1e-3 * want


def _held(group):
    res, params = group
    return res.case("held-blocks"), params["held-blocks"]


def test_held_blocks_three_applies_bit_for_bit(group):
    """Three applies of an X-sharded Wilson-clover operator, each equal
    bit for bit to the apply that extends blocks and field afresh (what
    every apply did before the blocks were held)."""
    outs, _ = _held(group)
    for r, got in enumerate(outs):
        assert got["applies"] == [True, True, True], f"rank {r}"


def test_held_blocks_build_once_then_reuse(group):
    """The three applies build the hop's extended blocks once and take
    them twice; the memo holds one entry of the extended slab's bytes,
    which ``report_cache_usage`` reports."""
    outs, p = _held(group)
    X, Y, Z, T = p["lat"]
    # 9 directions x 3x3 colour blocks (the spin factors ride the kron),
    # re and im, f32, on the rank's 2 x-planes and a halo plane a side
    want = 2 * 9 * 9 * (X // 4 + 2) * Y * Z * T * 4
    for r, got in enumerate(outs):
        assert got["after_applies"] == (1, 2, 1), f"rank {r}"
        assert got["bytes"] == want, f"rank {r}"
        assert got["report"] == {"entries": 1, "bytes": want}, f"rank {r}"


@pytest.mark.parametrize("what", ["inplace", "inplace_local", "power", "new_op",
                                  "after_clear"])
def test_held_blocks_build_again(group, what):
    """An in-place change of the blocks (through the DTensor, or on the
    rank's shard), another ``power``, a new operator's blocks, or
    ``clear_caches`` before the apply: one build, no reuse, and the result
    still equals the fresh extension's bit for bit."""
    outs, _ = _held(group)
    entries = {"inplace": 1, "inplace_local": 1, "power": 2, "new_op": 3,
               "after_clear": 1}[what]
    for r, got in enumerate(outs):
        assert got[what] == (True, 1, 0, entries), f"rank {r}"


def test_held_blocks_same_blocks_reuse(group):
    """An operator rebuilt with ``replace`` around the same blocks takes
    the held extension: the memo is keyed on the blocks, not the
    operator."""
    outs, _ = _held(group)
    for r, got in enumerate(outs):
        assert got["same_blocks"] == (True, 0, 1, 1), f"rank {r}"


def test_held_blocks_radius_zero_builds_nothing(group):
    """The clover term (radius 0 on every axis) extends nothing and holds
    nothing."""
    outs, _ = _held(group)
    for r, got in enumerate(outs):
        assert got["clover_term"] == (True, 0, 0, 1), f"rank {r}"


def test_held_blocks_lifetime_and_clear(group):
    """The entry of a deleted operator's blocks goes with them (the memo
    holds no reference to them); ``clear_caches`` drops every entry."""
    outs, _ = _held(group)
    for r, got in enumerate(outs):
        assert got["deleted"] == (0, 0, 2), f"rank {r}"
        assert got["cleared"] == (0, 0, 0), f"rank {r}"


@pytest.mark.parametrize("what", ["plain", "inference"])
def test_held_blocks_plain_and_inference_blocks(group, what):
    """Blocks every rank holds whole are cut to the rank's slab and held by
    the tensor they are cut from (one build, one reuse); inference tensors
    keep no version, so they are extended on every apply and never
    held."""
    outs, _ = _held(group)
    want = {"plain": [True, True, 1, 1, 3], "inference": [True, True, 0, 0, 3]}[what]
    for r, got in enumerate(outs):
        assert got[what] == want, f"rank {r}"
