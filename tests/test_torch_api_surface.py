"""The port's public surface against the JAX package's: every name in the
``__all__`` of a reference module that the port has a counterpart of (its
public top-level functions where it has no ``__all__``) exists in that
counterpart, or stands in this file's list of names still
to port (or not carried over, with the reason).  The reference modules are
read with ``ast``, so the surface test imports no JAX.  Every ported
public function takes the reference's parameters in the reference's
positions (fault P5: the port may only append its own, such as
``device``), and a positional ``interpret`` leaves the apply unpacked.
Then the names fault P4 found missing, against the JAX package's:
``cplx.asarray``, ``cplx.cmatmul`` and ``cg_solve``'s ``tol``."""

import ast
import importlib
import inspect
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
    "dense.py": "superbblas_tpu_torch.dense",
    "storage.py": "superbblas_tpu_torch.storage",
    "native/__init__.py": "superbblas_tpu_torch.native",
    "flags.py": "superbblas_tpu_torch.flags",
    "context.py": "superbblas_tpu_torch.context",
    "aot.py": "superbblas_tpu_torch.aot",
    "utils/__init__.py": "superbblas_tpu_torch.utils",
    "utils/tracker.py": "superbblas_tpu_torch.utils.tracker",
    "utils/caches.py": "superbblas_tpu_torch.utils.caches",
    "utils/testing.py": "superbblas_tpu_torch.utils.testing",
    "parallel/__init__.py": "superbblas_tpu_torch.parallel",
    "parallel/partition.py": "superbblas_tpu_torch.parallel.partition",
    "parallel/mesh.py": "superbblas_tpu_torch.parallel.mesh",
    "parallel/multihost.py": "superbblas_tpu_torch.parallel.multihost",
    "parallel/halo.py": "superbblas_tpu_torch.parallel.halo",
    "parallel/stencil_sharded.py": "superbblas_tpu_torch.parallel.stencil_sharded",
    "parallel/dist.py": "superbblas_tpu_torch.parallel.dist",
    "parallel/redistribute.py": "superbblas_tpu_torch.parallel.redistribute",
    "parallel/overlap.py": "superbblas_tpu_torch.parallel.overlap",
    "parallel/powers.py": "superbblas_tpu_torch.parallel.powers",
    "parallel/gather_sharded.py": "superbblas_tpu_torch.parallel.gather_sharded",
}

#: names of a reference module's __all__ the port does not have yet, by
#: module, with the queue item that brings them (none: every module of the
#: JAX package has its counterpart)
STILL_TO_PORT: dict = {}
#: names the port does not carry over, with the reason
NOT_CARRIED = {
    "context.py": {
        "create_tpu_context": "the TPU's context; the card's is create_gpu_context, the "
                              "reference library's createGpuContext"},
    "flags.py": {
        "get_use_pallas": "SBT_PALLAS switches the TPU's dispatch to Pallas; a CUDA tensor "
                          "always takes its kernel, so no dispatch here would read it",
        "get_track_mem": "SBT_TRACK_MEM has no reader in the JAX package either"},
    "ops/batched_gemm_pallas.py": {
        "batched_gemm_eligible": "the TPU's padding rule; the card's route is "
                                 "batched_gemm_route"},
    "ops/permute_pallas.py": {
        "pallas_permute": "the Pallas entry; the card's kernel entry is permute_4d, "
                          "reached through maybe_permute"},
}
_RAGGED = ("exists because XLA:CPU has no ragged all-to-all; the port's exchange, "
           "dist.all_to_all_single, takes ragged splits on gloo and NCCL alike")
#: private helpers of the reference the port does not carry over, with the
#: reason (held apart: the surface test reads only public names)
NOT_CARRIED_PRIVATE = {
    "parallel/redistribute.py": {"_exchange_ragged_emulated": _RAGGED,
                                 "_supports_ragged": _RAGGED},
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


def reference_public(rel: str):
    """A reference module's public names: its ``__all__``, or, where it
    has none, the functions it defines at top level whose names do not
    start with an underscore."""
    names = reference_all(rel)
    if names is None:
        names = [n for n in reference_functions(rel) if not n.startswith("_")]
    return names


@pytest.mark.parametrize("rel", sorted(COUNTERPARTS))
def test_reference_names_exist_in_the_port(rel):
    names = reference_public(rel)
    port = importlib.import_module(COUNTERPARTS[rel])
    listed = {**STILL_TO_PORT.get(rel, {}), **NOT_CARRIED.get(rel, {})}
    missing = [n for n in names if not hasattr(port, n) and n not in listed]
    assert not missing, f"{COUNTERPARTS[rel]} lacks {missing} of superbblas_tpu/{rel}"
    # a listed name that the port has is stale in the list
    stale = [n for n in listed if hasattr(port, n) or n not in names]
    assert not stale, f"listed for {rel} but present or not in __all__: {stale}"


def test_private_helpers_not_carried():
    """The reference's private helpers listed as not carried exist there
    and not in the port."""
    for rel, names in NOT_CARRIED_PRIVATE.items():
        port = importlib.import_module(COUNTERPARTS[rel])
        ref = reference_functions(rel)
        for name in names:
            assert name in ref, (rel, name)
            assert not hasattr(port, name), (rel, name)


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
                 "bsr_get_preferred_layout", "bsr_krylov", "create_bsr", "create_kron_bsr"):
        assert getattr(sbt, name) is getattr(bsr, name), name


def reference_functions(rel: str) -> dict:
    """{name: positional parameter names} of the functions a reference
    module defines at top level, read with ``ast``."""
    tree = ast.parse((REF / rel).read_text())
    return {node.name: [a.arg for a in node.args.posonlyargs + node.args.args]
            for node in tree.body if isinstance(node, ast.FunctionDef)}


@pytest.mark.parametrize("rel", sorted(COUNTERPARTS))
def test_ported_functions_take_the_reference_parameters(rel):
    """Each public function of a reference module that the port has takes
    the reference's positional parameters, in order, before any of the
    port's own (which have defaults): a positional call written for the
    JAX package means the same to the port."""
    funcs = reference_functions(rel)
    port = importlib.import_module(COUNTERPARTS[rel])
    public = set(reference_all(rel) or ()) | {n for n in funcs if not n.startswith("_")}
    checked = 0
    for name in sorted(public & set(funcs)):
        fn = getattr(port, name, None)
        if fn is None or inspect.isclass(fn) or not callable(fn):
            continue
        params = list(inspect.signature(fn).parameters.values())
        positional = [p for p in params if p.kind in (p.POSITIONAL_ONLY,
                                                      p.POSITIONAL_OR_KEYWORD)]
        ref = funcs[name]
        assert [p.name for p in positional[:len(ref)]] == ref, \
            f"{COUNTERPARTS[rel]}.{name}{inspect.signature(fn)} against the reference's {ref}"
        extra = positional[len(ref):]
        assert all(p.default is not p.empty for p in extra), \
            f"{COUNTERPARTS[rel]}.{name}: appended parameters need defaults"
        checked += 1
    assert checked or not (public & set(funcs)), rel


def test_positional_interpret_applies_unpacked():
    """``apply_stencil_soa(op, x, True)`` reads True as the reference's
    ``interpret`` (accepted, unused), not as a packed parity; likewise
    ``stencil_matvec_soa``'s seventh argument and ``batched_small_gemm``'s
    third."""
    from superbblas_tpu_torch import bsr
    from superbblas_tpu_torch.models import wilson as TW
    from superbblas_tpu_torch.ops import batched_gemm as G
    from superbblas_tpu_torch.ops import stencil as S

    lat = (4, 4, 4, 4)
    op = TW.wilson_operator(lat, mass=0.3, key=1, dtype=torch.complex128, layout="soa",
                            device="cpu")
    rng = np.random.default_rng(4)
    x = TW.CArray(*(torch.from_numpy(rng.standard_normal((2, 12) + lat)) for _ in range(2)))
    want = bsr.apply_stencil_soa(op, x)
    for got in (bsr.apply_stencil_soa(op, x, True),
                S.stencil_matvec_soa(op.blocks, op.kron, x, op.offsets, 3, 3, True)):
        assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    from superbblas_tpu_torch.models import eo_packed as E

    hop, src = E.hopping_packed_soa(op, 0), E.cb_pack_soa(x, 1)
    packed = bsr.apply_stencil_soa(hop, src, None, 0)
    want = E.apply_hopping_packed_soa(hop, src, 0, None)
    assert torch.equal(packed.re, want.re) and torch.equal(packed.im, want.im)
    with pytest.raises(ValueError, match="chunks"):
        S.stencil_matvec_soa(op.blocks, op.kron, x, op.offsets, 3, 3, False, None, (3, 1))
    b = torch.from_numpy(rng.standard_normal((5, 3, 4)))
    xx = torch.from_numpy(rng.standard_normal((5, 4, 2)))
    assert torch.equal(G.batched_small_gemm(b, xx, True, True), G.batched_small_gemm(b, xx))


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
