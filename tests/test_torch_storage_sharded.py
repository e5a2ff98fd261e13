"""superbblas_tpu_torch.storage's sharded checkpoints against
superbblas_tpu's, on one gloo group of 4 processes (run with SBT_DEBUG=1,
so every collective entry is hashed across ranks).

``create_storage_sharded`` / ``save_sharded`` (also twice, and
``save_sharded_async``) / ``close_storage_sharded`` write one S3T block
per rank's shard, declared by rank 0 in rank order; the file is byte for
byte the JAX package's written from a 4-device mesh with the same
sharding, at checksum levels 0, 1 and 2, real and complex.  Each file
reloads bit for bit with ``load_sharded`` onto another sharding, in the
group (the port reading the JAX package's file too) and in this process
with the JAX package's ``load_sharded`` (the JAX package reading the
port's).  ``utils.testing.check_collective_consistency`` passes on an
agreeing payload and raises on every rank together on a disagreeing
one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_dist import run_group
from superbblas_tpu import cplx as jcplx
from superbblas_tpu import storage as jst

XY = ((2, 2), ("X", "Y"))
DIM = (8, 8, 6)


def jmesh(m):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(m[0]), m[1])


def _cases(tmp):
    rng = np.random.default_rng(0)
    c = []
    for name, kw in (("real-crc2", dict(checksum=2)),
                     ("real-crc0-twice", dict(checksum=0, twice=True)),
                     ("complex-crc1", dict(checksum=1, complex=True)),
                     ("real-async-crc1", dict(checksum=1, **{"async": True})),
                     ("complex-yspec-crc2", dict(checksum=2, complex=True, spec=(None, "Y", "X")))):
        x = rng.standard_normal(DIM)
        if kw.pop("complex", False):
            x = (x, rng.standard_normal(DIM))
        spec = kw.pop("spec", ("X", "Y", None))
        c.append((name, "storage", dict(kw, mesh=XY, x=x, spec=spec, order="xyn", dim=DIM,
                                        path=str(tmp / f"{name}.port.s3t"),
                                        jax_path=str(tmp / f"{name}.jax.s3t"),
                                        mesh2=((4,), ("P",)), spec2=(None, "P", None))))
    c.append(("consistency", "consistency", {}))
    return c


def _jx(x):
    return (jnp.asarray(x[0]) + 1j * jnp.asarray(x[1])) if isinstance(x, tuple) \
        else jnp.asarray(x)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("storage_sharded")
    cases = _cases(tmp)
    for _, kind, p in cases:          # the JAX package's files, from 4 devices
        if kind != "storage":
            continue
        xs = jax.device_put(_jx(p["x"]), NamedSharding(jmesh(p["mesh"]), P(*p["spec"])))
        dt = np.complex128 if isinstance(p["x"], tuple) else np.float64
        sto = jst.create_storage(p["jax_path"], p["order"], p["dim"], dtype=dt,
                                 checksum=p["checksum"])
        if p.get("async"):
            jst.save_sharded_async(sto, xs, p["order"]).result()
        else:
            jst.save_sharded(sto, xs, p["order"])
        jst.close_storage(sto)
    res = run_group("storage_sharded", cases, tmp, env={"SBT_DEBUG": "1"})
    return res, {n: p for n, _, p in cases}


def _np(v):
    return v[0] + 1j * v[1] if isinstance(v, tuple) else v


@pytest.mark.parametrize("name", [c[0] for c in _cases(__import__("pathlib").Path("."))
                                  if c[1] == "storage"])
def test_sharded_checkpoint_matches_jax(group, name):
    res, params = group
    p = params[name]
    x = _np(p["x"])
    outs = res.case(name)
    with open(p["path"], "rb") as f, open(p["jax_path"], "rb") as g:
        assert f.read() == g.read(), "the port's file differs from the JAX package's"
    for r, got in enumerate(outs):
        np.testing.assert_array_equal(_np(got["own_full"]), x)
        np.testing.assert_array_equal(_np(got["jax_full"]), x)
        L = DIM[1] // 4
        np.testing.assert_array_equal(_np(got["own_local"]), x[:, r * L:(r + 1) * L])
    # the JAX package reads the port's 4-block file onto its own sharding
    sto = jst.open_storage(p["path"], mode="r")
    jst.check_or_write_checksums(sto)
    assert len(sto.blocks) == 4
    back = jst.load_sharded(sto, NamedSharding(jmesh(((4,), ("P",))), P(None, "P", None)))
    jst.close_storage(sto)
    got = np.asarray(back.re) + 1j * np.asarray(back.im) if isinstance(back, jcplx.CArray) \
        else np.asarray(back)
    np.testing.assert_array_equal(got, x)


def test_collective_consistency_raises_on_every_rank(group):
    res, _ = group
    for got in res.case("consistency"):
        assert "cross-process divergence at collective entry 'sbt:test:diverge'" in got["raised"]
