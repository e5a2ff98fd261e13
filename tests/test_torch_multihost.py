"""superbblas_tpu_torch.parallel.multihost on a gloo group of 4 processes.

``initialize_distributed`` is idempotent on a running group;
``make_multihost_mesh`` places the ``dcn_axis``'s leading factor over
hosts (ranks grouped by LOCAL_WORLD_SIZE) exactly as the JAX package's
fallback for meshes without slice topology orders devices
(process-major, ``superbblas_tpu/parallel/multihost.py:87-98``), and a
global all-reduce and a halo exchange run across the mesh.  The JAX
reference layout is that function's own arithmetic, run on device ids
numbered by process as jax.distributed numbers them."""

import numpy as np
import pytest

from _torch_dist import run_group

CASES = [
    ("x4-dcn-2hosts", dict(axes={"x": 4}, dcn_axis="x", per_host=2)),
    ("xy-dcn-x-2hosts", dict(axes={"x": 2, "y": 2}, dcn_axis="x", per_host=2)),
    ("xy-dcn-y-2hosts", dict(axes={"x": 2, "y": 2}, dcn_axis="y", per_host=2)),
    ("xy-dcn-y-4hosts", dict(axes={"y": 4, "x": 1}, dcn_axis="y", per_host=1)),
    ("xy-one-host", dict(axes={"x": 2, "y": 2}, dcn_axis=None, per_host=4)),
]


def jax_fallback_layout(axes, dcn_axis, per_host, world=4):
    """The device order JAX's make_multihost_mesh builds without slice
    topology: devices sorted by (process, id), the dcn axis's leading
    factor over processes."""
    names = list(axes)
    nproc = world // per_host
    devs = np.arange(world)
    if dcn_axis is None or nproc == 1:
        return devs.reshape([axes[n] for n in names])
    pos = names.index(dcn_axis)
    inner = axes[dcn_axis] // nproc
    others = [axes[n] for i, n in enumerate(names) if i != pos]
    arr = devs.reshape((nproc, inner) + tuple(others))
    arr = arr.reshape((nproc * inner,) + tuple(others))
    return np.moveaxis(arr, 0, pos)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    x = np.arange(32.0).reshape(8, 4)
    cases = [(n, "multihost", dict(p, x=x)) for n, p in CASES]
    return run_group("multihost", cases, tmp_path_factory.mktemp("multihost"))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_multihost_mesh_layout_and_collectives(group, name):
    p = next(c[1] for c in CASES if c[0] == name)
    want = jax_fallback_layout(p["axes"], p["dcn_axis"], p["per_host"])
    x = np.arange(32.0).reshape(8, 4)
    first = list(p["axes"])[0]
    n = p["axes"][first]
    for r, got in enumerate(group.case(name)):
        np.testing.assert_array_equal(got["ranks"], want)
        assert got["sum"] == 10.0
        # this rank's slab along the first axis, one halo row a side
        c = int(np.argwhere(want == r)[0][0])
        L = 8 // n
        rows = np.arange(c * L - 1, (c + 1) * L + 1) % 8
        np.testing.assert_array_equal(got["halo"], x[rows])


def test_make_multihost_mesh_needs_a_group():
    import torch.distributed as dist

    from superbblas_tpu_torch import parallel as tpar

    if dist.is_initialized():
        pytest.skip("a process group is up in this process")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tpar.make_multihost_mesh({"x": 1})
