"""The port's public surface against the JAX package's: every name in the
``__all__`` of a reference module that the port has a counterpart of
exists in that counterpart, or stands in this file's list of names still
to port (or not carried over, with the reason).  The reference modules are
read with ``ast``, so the surface test imports no JAX.  Then the names
fault P4 found missing, against the JAX package's: ``cplx.asarray``,
``cplx.cmatmul`` and ``cg_solve``'s ``tol``."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "superbblas_tpu"

#: reference module (path under superbblas_tpu/) -> the port's module
COUNTERPARTS = {
    "__init__.py": "superbblas_tpu_torch",
    "bsr.py": "superbblas_tpu_torch.bsr",
    "cplx.py": "superbblas_tpu_torch.cplx",
    "labels.py": "superbblas_tpu_torch.labels",
    "solvers.py": "superbblas_tpu_torch.solvers",
    "models/__init__.py": "superbblas_tpu_torch.models",
    "models/wilson.py": "superbblas_tpu_torch.models.wilson",
    "models/clover.py": "superbblas_tpu_torch.models.clover",
    "models/staggered.py": "superbblas_tpu_torch.models.staggered",
    "models/domain_wall.py": "superbblas_tpu_torch.models.domain_wall",
    "models/coarse.py": "superbblas_tpu_torch.models.coarse",
    "models/multigrid.py": "superbblas_tpu_torch.models.multigrid",
    "models/even_odd.py": "superbblas_tpu_torch.models.even_odd",
    "models/eo_packed.py": "superbblas_tpu_torch.models.eo_packed",
    "ops/__init__.py": "superbblas_tpu_torch.ops",
    "ops/copy.py": "superbblas_tpu_torch.ops.copy",
    "ops/contract.py": "superbblas_tpu_torch.ops.contract",
    "ops/reduce.py": "superbblas_tpu_torch.ops.reduce",
    "ops/stencil_pallas.py": "superbblas_tpu_torch.ops.stencil",
    "ops/batched_gemm_pallas.py": "superbblas_tpu_torch.ops.batched_gemm",
    "ops/permute_pallas.py": "superbblas_tpu_torch.ops.permute",
}

_AOS_EO = "the AoS even-odd functions: ROADMAP.md Queue 1 item 2"
_GATHER = "the gather modes of bsr.py: ROADMAP.md Queue 1 item 3"
_DENSE = "dense.py: ROADMAP.md Queue 1 item 4"
_STORAGE = "storage.py and the native plan engine: ROADMAP.md Queue 1 item 5"
_UTILS = "the utilities: ROADMAP.md Queue 1 item 6"
_DIST = "the distributed layer: ROADMAP.md Queue 1 item 7"
#: names of a reference module's __all__ the port does not have yet, by
#: module, with the queue item that brings them
STILL_TO_PORT = {
    "__init__.py": {
        "aot": _UTILS, "context": _UTILS, "flags": _UTILS, "utils": _UTILS,
        "dense": _DENSE, "cholesky": _DENSE, "trsm": _DENSE, "gesm": _DENSE,
        "inversion": _DENSE, "native": _STORAGE, "storage": _STORAGE,
        "create_bsr": _GATHER, "create_kron_bsr": _GATHER,
        "parallel": _DIST, "Partition": _DIST, "basic_partitioning": _DIST,
        "contraction": _DIST, "copy": _DIST, "make_hole": _DIST, "make_mesh": _DIST,
        "partition_sharding": _DIST, "partitioning_distributed_procs": _DIST,
        "reshard": _DIST},
    "bsr.py": {"bsr_allowed_layouts": _GATHER},
    "models/__init__.py": {name: _AOS_EO for name in (
        "eo_solve", "schur_matvec", "apply_hopping_packed", "cb_pack", "cb_unpack",
        "eo_solve_packed", "hopping_packed")},
    "models/even_odd.py": {"eo_solve": _AOS_EO, "schur_matvec": _AOS_EO},
    "models/eo_packed.py": {name: _AOS_EO for name in (
        "cb_pack", "cb_unpack", "hopping_packed", "apply_hopping_packed", "eo_solve_packed")},
}
#: names the port does not carry over, with the reason
NOT_CARRIED = {
    "ops/batched_gemm_pallas.py": {
        "batched_gemm_eligible": "the TPU's padding rule; the card's route is "
                                 "batched_gemm_route"},
    "ops/permute_pallas.py": {
        "pallas_permute": "the Pallas entry; the card's kernel entry is permute_4d, "
                          "reached through maybe_permute"},
}


def reference_all(rel: str):
    """The literal ``__all__`` of a reference module (None where it has
    none), read without importing it."""
    tree = ast.parse((REF / rel).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


@pytest.mark.parametrize("rel", sorted(COUNTERPARTS))
def test_reference_names_exist_in_the_port(rel):
    names = reference_all(rel)
    port = importlib.import_module(COUNTERPARTS[rel])
    listed = {**STILL_TO_PORT.get(rel, {}), **NOT_CARRIED.get(rel, {})}
    if names is None:
        assert not listed
        return
    missing = [n for n in names if not hasattr(port, n) and n not in listed]
    assert not missing, f"{COUNTERPARTS[rel]} lacks {missing} of superbblas_tpu/{rel}"
    # a listed name that the port has is stale in the list
    stale = [n for n in listed if hasattr(port, n) or n not in names]
    assert not stale, f"listed for {rel} but present or not in __all__: {stale}"


def test_every_counterpart_module_exists():
    for rel in COUNTERPARTS:
        assert (REF / rel).is_file(), rel
    for rel in set(STILL_TO_PORT) | set(NOT_CARRIED):
        assert rel in COUNTERPARTS, rel


def test_port_all_lists_only_what_it_has():
    for mod in sorted(set(COUNTERPARTS.values())):
        port = importlib.import_module(mod)
        for name in getattr(port, "__all__", []):
            assert hasattr(port, name), f"{mod}.__all__ lists missing {name}"


def test_top_level_bsr_names():
    import superbblas_tpu_torch as sbt
    from superbblas_tpu_torch import bsr

    for name in ("BSROperator", "bsr_from_stencil", "bsr_cast_storage",
                 "bsr_get_preferred_layout", "bsr_krylov"):
        assert getattr(sbt, name) is getattr(bsr, name), name


@pytest.mark.parametrize("case", ["complex", "real", "carray", "complex_tensor"])
def test_cplx_asarray_matches_jax(case):
    """A CArray for complex input (numpy or tensor), a plain tensor for
    real input, a CArray unchanged: as the JAX package's ``asarray``."""
    from superbblas_tpu import cplx as JC
    from superbblas_tpu_torch import cplx as TC

    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 4))
    val = {"complex": a + 1j * rng.standard_normal((3, 4)), "real": a,
           "carray": None, "complex_tensor": None}[case]
    if case == "carray":
        t_in = TC.CArray(torch.from_numpy(a), torch.from_numpy(2 * a))
        assert TC.asarray(t_in) is t_in
        return
    if case == "complex_tensor":
        c = a + 1j * a[::-1]
        got = TC.asarray(torch.from_numpy(c))
        want = JC.asarray(c)
    else:
        got, want = TC.asarray(val), JC.asarray(val)
    assert TC.is_carray(got) == JC.is_carray(want)
    parts = zip(got, want) if TC.is_carray(got) else ((got, want),)
    for g, w in parts:
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shapes", [((3, 4), (4, 5)), ((2, 3, 4), (4, 2)), ((3, 4), (4,)),
                                    ((5, 4), (3, 4, 6))])
@pytest.mark.parametrize("kind", ["carray", "mixed", "real"])
def test_cplx_cmatmul_matches_jax(shapes, kind):
    """a's last axis against b's second-to-last (its only one for a
    vector), at f64, split complex, mixed or real, as JAX's cmatmul."""
    import jax.numpy as jnp

    from superbblas_tpu import cplx as JC
    from superbblas_tpu_torch import cplx as TC

    rng = np.random.default_rng(2)
    sa, sb = shapes
    a = rng.standard_normal(sa) + 1j * rng.standard_normal(sa)
    b = rng.standard_normal(sb) + 1j * rng.standard_normal(sb)
    if kind == "real":
        a, b = a.real.copy(), b.real.copy()
    ja = JC.from_complex(a) if kind != "real" else jnp.asarray(a)
    jb = JC.from_complex(b) if kind == "carray" else jnp.asarray(b.real.copy())
    ta = TC.from_complex(a) if kind != "real" else torch.from_numpy(a)
    tb = TC.from_complex(b) if kind == "carray" else torch.from_numpy(b.real.copy())
    got, want = TC.cmatmul(ta, tb), JC.cmatmul(ja, jb)
    gp = tuple(got) if TC.is_carray(got) else (got,)
    wp = tuple(want) if JC.is_carray(want) else (want,)
    assert len(gp) == len(wp)
    for g, w in zip(gp, wp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_cg_solve_takes_tol():
    """``cg_solve(..., tol=...)`` is accepted and, as in the JAX package,
    leaves the fixed iteration count unchanged."""
    from superbblas_tpu_torch.models import wilson as TW

    lat = (2, 2, 2, 4)
    op = TW.wilson_operator(lat, mass=0.5, key=0, dtype=torch.complex128, layout="soa",
                            device="cpu")
    rng = np.random.default_rng(3)
    b = TW.CArray(*(torch.from_numpy(rng.standard_normal((1, 12) + lat)) for _ in range(2)))
    x0, r0 = TW.cg_solve(op, b, n_iters=4)
    x1, r1 = TW.cg_solve(op, b, n_iters=4, tol=1e-3)
    assert torch.equal(x0.re, x1.re) and torch.equal(x0.im, x1.im) and torch.equal(r0, r1)
