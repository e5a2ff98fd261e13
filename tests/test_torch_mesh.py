"""superbblas_tpu_torch.parallel.mesh against superbblas_tpu's.

``partition_sharding`` gives a sharding exactly where JAX's does (grids
that divide evenly, replicated, on master) and None where JAX's does
(uneven grids, halos, overlaps); the boxes of every sharding, through
``sharding_partition``, equal the JAX sharding's (compared in-process).
On a gloo group of 4 processes, ``make_mesh`` lays the ranks out as the
JAX mesh lays out devices, and a DTensor sharded by a spec holds the
blocks JAX's NamedSharding gives each device.  Without a card the CUDA
default raises; the CPU comes only when named."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_dist import run_group
from superbblas_tpu import parallel as jpar
from superbblas_tpu_torch import parallel as tpar

PARTS = [
    ("grid", ("xyts", (8, 8, 4, 3), (2, 2, 1, 1)), {}),
    ("grid3", ("xyz", (8, 6, 4), (2, 1, 2)), {}),
    ("dist-labels", ("xy", (4, 4), (2, 2)), {"dist_labels": "yx"}),
    ("replicated", ("xy", (4, 4), (1, 1)), {"nprocs": 4, "replicate": True}),
    ("uneven", ("x", (10,), (4,)), {}),
    ("halo", ("x", (16,), (4,)), {"ext_power": (1,)}),
    ("on-master", ("xy", (4, 4), (1, 1)), {"nprocs": 4}),
    ("trailing-empty", ("xy", (8, 8), (2, 1)), {"nprocs": 4}),
    ("one-axis", ("xyzt", (32, 32, 32, 64), (4, 1, 1, 1)), {}),
]


def _jboxes(sh, dim):
    if isinstance(sh, jax.sharding.SingleDeviceSharding):
        return ("single",)
    return tuple(jpar.sharding_partition(sh, dim).boxes)


def _tboxes(sh, dim):
    if isinstance(sh, tpar.SingleDeviceSharding):
        return ("single",)
    return tuple(tpar.sharding_partition(sh, dim).boxes)


@pytest.mark.parametrize("case", PARTS, ids=[c[0] for c in PARTS])
def test_partition_sharding_matches_jax(case):
    _, args, kw = case
    jp, tp = jpar.basic_partitioning(*args, **kw), tpar.basic_partitioning(*args, **kw)
    js = jpar.partition_sharding(jp, args[0], devices=jax.devices()[:4])
    ts = tpar.partition_sharding(tp, args[0])
    assert (js is None) == (ts is None)
    if js is None:
        return
    assert _tboxes(ts, tp.dim) == _jboxes(js, jp.dim)
    if isinstance(ts, tpar.NamedSharding):
        assert tuple(ts.spec) == tuple(js.spec)
        assert tuple(ts.mesh.mesh_dim_names) == tuple(js.mesh.axis_names)
        assert [d.id for d in js.mesh.devices.reshape(-1)] == list(ts.mesh.ranks)


def test_sharding_partition_roundtrip_matches_jax():
    jm = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    tm = tpar.RankGrid((0, 1, 2, 3), (2, 2), ("x", "y"), "cpu")
    for spec, shape in ((("x", "y", None), (8, 8, 3)), (("y", None), (6, 5)),
                        ((None, "x"), (3, 8)), ((), (4, 4))):
        j = jpar.sharding_partition(NamedSharding(jm, P(*spec)), shape)
        t = tpar.sharding_partition(tpar.NamedSharding(tm, tpar.PartitionSpec(*spec)), shape)
        assert t.boxes == j.boxes and t.dim == j.dim
        assert t.grid_shape() == j.grid_shape()


def test_cuda_default_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="devices='cpu'"):
        tpar.make_mesh({"x": 1})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpar.initialize_distributed()


MESH_CASES = [
    ("mesh-2x2-xy", dict(mesh=((2, 2), ("x", "y")), spec=("x", "y", None))),
    ("mesh-2x2-yx", dict(mesh=((2, 2), ("x", "y")), spec=("y", None, "x"))),
    ("mesh-4", dict(mesh=((4,), ("p",)), spec=(None, "p", None))),
    # one array axis over both mesh axes, x major (DTensor's [Shard(0), Shard(0)])
    ("mesh-2x2-one-axis", dict(mesh=((2, 2), ("x", "y")), spec=(("x", "y"), None, None))),
    ("mesh-4-replicated", dict(mesh=((4,), ("p",)), spec=(None, None, None))),
]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = [(n, "mesh", dict(p, x=rng.standard_normal((8, 8, 4)))) for n, p in MESH_CASES]
    return run_group("mesh", cases, tmp_path_factory.mktemp("mesh")), cases


@pytest.mark.parametrize("name", [c[0] for c in MESH_CASES])
def test_make_mesh_and_dtensor_blocks_match_jax(group, name):
    res, cases = group
    p = next(c[2] for c in cases if c[0] == name)
    shape, names = p["mesh"]
    jm = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), names)
    xj = jax.device_put(jnp.asarray(p["x"]), NamedSharding(jm, P(*p["spec"])))
    shards = {s.device.id: np.asarray(s.data) for s in xj.addressable_shards}
    want_boxes = jpar.sharding_partition(xj.sharding, p["x"].shape).boxes
    for r, got in enumerate(res.case(name)):
        np.testing.assert_array_equal(got["ranks"], np.arange(4).reshape(shape))
        assert got["names"] == tuple(names)
        assert tuple(got["boxes"]) == tuple(want_boxes)
        assert tuple(got["spec_boxes"]) == tuple(want_boxes)
        np.testing.assert_array_equal(got["local"], shards[r])
