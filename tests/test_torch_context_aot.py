"""superbblas_tpu_torch.context and .aot: the counterparts of
tests/test_context_aot.py, held against the JAX package at f64 (1e-12
relative): contexts and make_sure, wait, the concurrent scope,
aot_compile and export_compiled/load_exported of local_contraction and
of apply_wilson with a CArray argument.  create_context raises without a
card; the exported SoA apply holds K1 as its custom op."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superbblas_tpu_torch import aot, context, cplx, local_contraction

from _torch_parity import assert_parity


def test_context_and_make_sure():
    ctx = context.create_cpu_context()
    assert ctx.device == torch.device("cpu")
    x = context.make_sure(torch.ones((2, 2)), ctx)
    assert x.device == ctx.device
    c = context.make_sure(cplx.CArray(torch.ones(2), torch.zeros(2)), ctx)
    assert cplx.is_carray(c) and c.device == ctx.device
    assert context.Context("cuda", 1).device == torch.device("cuda", 1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a card")
def test_create_context_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.create_context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.create_gpu_context(0)


def test_wait_returns_value():
    from concurrent.futures import ThreadPoolExecutor

    y = torch.ones((4,)) * 3
    out = context.wait(y)
    assert out is y
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(lambda: 5)
        tree = context.wait({"a": y, "f": fut})
    assert tree["f"].done()


def test_concurrent_scope_runs():
    with context.concurrent("fork"):
        a = torch.ones((4,)).sum()
    assert float(a) == 4.0


def contraction(a, b):
    return local_contraction(1.0, a, "ij", False, b, "jk", False, 0.0, None, "ik")


def test_aot_compile_and_export(tmp_path):
    """The JAX test's contraction: the compiled and the exported program
    match the eager call and JAX's; both refuse another shape."""
    from superbblas_tpu import local_contraction as jlc

    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((4, 5)), rng.standard_normal((5, 6))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = jlc(1.0, jnp.asarray(a), "ij", False, jnp.asarray(b), "jk", False, 0.0, None, "ik")
    exe = aot.aot_compile(contraction, (ta, tb))
    assert_parity(exe(ta, tb), want, np.float64)
    with pytest.raises(TypeError, match="signature"):
        exe(ta, torch.ones(5, 7, dtype=torch.float64))
    with pytest.raises(TypeError, match="signature"):
        exe(ta.float(), tb)
    p = str(tmp_path / "op.pt2")
    assert aot.export_compiled(contraction, (ta, tb), p) == p
    g = aot.load_exported(p)
    assert_parity(g(ta, tb), want, np.float64)
    with pytest.raises(Exception):
        g(torch.ones(3, 5, dtype=torch.float64), tb)


def wilson_pair(layout):
    from superbblas_tpu import cplx as JC
    from superbblas_tpu.models import wilson as JW
    from superbblas_tpu_torch.models import wilson as TW

    lat = (4, 4, 2, 2) if layout == "aos" else (2, 2, 8, 128)   # JAX SoA: Z % 8, T % 128
    rng = np.random.default_rng(0)
    if layout == "aos":
        shape = lat + (4, 3, 2)
    else:
        shape = (2, 12) + lat
    re, im = rng.standard_normal(shape), rng.standard_normal(shape)
    jop = JW.wilson_operator(lat, mass=0.1, key=0, dtype=jnp.complex128, layout=layout)
    top = TW.wilson_operator(lat, mass=0.1, key=0, dtype=torch.complex128, layout=layout,
                             device="cpu")
    jx = JC.CArray(jnp.asarray(re), jnp.asarray(im))
    tx = cplx.CArray(torch.from_numpy(re), torch.from_numpy(im))
    return (lambda v: TW.apply_wilson(top, v)), tx, JW.apply_wilson(jop, jx)


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_aot_export_carray_step(tmp_path, layout):
    """apply_wilson with a CArray argument, exported, saved, loaded and
    run: a CArray equal to JAX's apply at f64 (the AoS layout of the JAX
    test, and the SoA layout, whose program holds K1's custom op)."""
    fn, x, want = wilson_pair(layout)
    exe = aot.aot_compile(fn, (x,))
    got = exe(x)
    assert_parity((got.re, got.im), (want.re, want.im), np.float64)
    path = str(tmp_path / "step.pt2")
    aot.export_compiled(fn, (x,), path)
    loaded = aot.load_exported(path)
    got = loaded(x)
    assert cplx.is_carray(got)
    assert_parity((got.re, got.im), (want.re, want.im), np.float64)
    targets = {str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"}
    assert ("sbt.stencil_matvec_soa.default" in targets) == (layout == "soa")


def test_stencil_op_fake_shapes():
    """K1's custom op under fake tensors gives the shapes of the eager
    call, packed parity and kron-less shapes included."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from superbblas_tpu_torch.models import wilson as TW

    lat = (4, 4, 2, 2)
    op = TW.wilson_operator(lat, mass=0.1, key=0, dtype=torch.complex64, layout="soa",
                            device="cpu")
    offs = [v for off in op.offsets for v in off]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        x = mode.from_tensor(torch.zeros((3, 12) + lat))
        y = torch.ops.sbt.stencil_matvec_soa(op.blocks.re, op.blocks.im, op.kron.re,
                                             op.kron.im, x, x, offs, 3, 3, -1)
        assert tuple(y[0].shape) == (3, 12) + lat
        b = mode.from_tensor(torch.zeros((9, 4) + lat))
        xs = mode.from_tensor(torch.zeros((5, 2) + lat))
        y = torch.ops.sbt.stencil_matvec_soa(b, b, None, None, xs, xs, offs, 2, 2, 0)
        assert tuple(y[1].shape) == (5, 2) + lat


def _fake_cuda(*shapes):
    """Fake f32 tensors on a CUDA device: traceable without a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return [torch.empty(s, device="cuda") for s in shapes]


@pytest.mark.parametrize("case,target", [
    ("local_permute", "sbt.permute_4d.default"),
    ("k3", "sbt.batched_small_gemm.default"),
    ("e1_by_shape", "sbt.batched_small_gemm.default"),
    ("e1", "sbt.batched_gemm_rowpack.default"),
])
def test_export_on_cuda_tensors_holds_kernel_ops(tmp_path, case, target):
    """Traced at fake CUDA tensors, a function reaching K2, K3 or E1 holds
    that kernel's custom op (the eager wrapper reads data pointers, which
    a traced tensor has not), and export_compiled saves it."""
    from superbblas_tpu_torch.ops import batched_gemm as G
    from superbblas_tpu_torch.ops.copy import local_permute

    fn, shapes = {
        "local_permute": (lambda v: local_permute(v, "xyzt", "tyzx"), [(6, 4, 5, 8)]),
        "k3": (G.batched_small_gemm, [(5, 3, 4), (5, 4, 2)]),
        "e1_by_shape": (G.batched_small_gemm, [(5, 70, 80), (5, 80, 2)]),
        "e1": (G.batched_gemm_rowpack, [(5, 3, 4), (5, 4, 2)]),
    }[case]
    args = tuple(_fake_cuda(*shapes))
    path = aot.export_compiled(fn, args, str(tmp_path / f"{case}.pt2"))
    program = torch.export.export(aot._Module(fn), args)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets == [target]
    assert (tmp_path / f"{case}.pt2").stat().st_size > 0 and path.endswith(".pt2")


def _probe_call(name):
    """(function, argument shapes and dtypes) of a call reaching one of the
    entries with no caller in the package: K1's runtime-shape route, the
    schedules K4a/K4b, the tile sweep E3 and the roll-add probe E2."""
    import superbblas_tpu_torch.cplx as TC
    from superbblas_tpu_torch.models.wilson import wilson_offsets
    from superbblas_tpu_torch.ops import permute as TP, roll_add as TR, stencil as TS

    lat = (8, 4, 4, 8)
    offs = wilson_offsets(4)
    soa = [(9, 9) + lat, (9, 9) + lat, (9, 4, 4), (9, 4, 4), (2, 12) + lat, (2, 12) + lat]
    if name in ("stencil_matvec_soa_rt", "stencil_matvec_soa_xin",
                "stencil_matvec_soa_stream"):
        entry = getattr(TS, name)

        def fn(br, bi, kr, ki, xr, xi):
            y = entry(TC.CArray(br, bi), TC.CArray(kr, ki), TC.CArray(xr, xi), offs, 3, 3)
            return y.re, y.im

        return fn, [(s, torch.float32) for s in soa]
    if name == "permute_4d_tiled":
        return (lambda v: TP.permute_4d_tiled(v, (3, 1, 2, 0), TP.TILES[0]),
                [((8, 4, 4, 64), torch.float32)])
    return (lambda v: TR.roll_add(v, "bf16x2"), [((4, 8, 64), torch.bfloat16)])


PROBES = ["stencil_matvec_soa_rt", "stencil_matvec_soa_xin", "stencil_matvec_soa_stream",
          "permute_4d_tiled", "roll_add"]


@pytest.mark.parametrize("name", PROBES)
def test_export_on_cuda_tensors_holds_probe_ops(tmp_path, name):
    """Traced at fake CUDA tensors, a call of an entry that no package path
    calls (K1's runtime-shape route, K4a, K4b, E3, E2) holds that entry's
    custom op and nothing else, and export_compiled saves it: the wrappers
    read data pointers and the schedules the kron's host value, which a
    traced tensor has not, so the op's real body runs them when the
    exported program runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn, specs = _probe_call(name)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(torch.empty(s, dtype=dt, device="cuda") for s, dt in specs)
    path = aot.export_compiled(fn, args, str(tmp_path / f"{name}.pt2"))
    program = torch.export.export(aot._Module(fn), args)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert [t for t in targets if t.startswith("sbt.")] == [f"sbt.{name}.default"]
    assert (tmp_path / f"{name}.pt2").stat().st_size > 0 and path.endswith(".pt2")


@pytest.mark.parametrize("name", PROBES)
def test_probe_custom_ops_pass_opcheck_and_match_the_eager_call(name):
    """Each probe entry's custom op on CPU tensors (its real body is the
    eager call, so the plain version): schema, fake implementation and
    real one agree (``torch.library.opcheck``), and the op gives the
    eager call's bits."""
    fn, specs = _probe_call(name)
    g = torch.Generator().manual_seed(5)
    args = [torch.randn(s, generator=g).to(dt) for s, dt in specs]
    op = getattr(torch.ops.sbt, name).default
    if name.startswith("stencil"):
        from superbblas_tpu_torch.models.wilson import wilson_offsets

        extra = {"stencil_matvec_soa_rt": [-1], "stencil_matvec_soa_xin": [],
                 "stencil_matvec_soa_stream": [-1]}[name]
        op_args = tuple(args) + ([v for off in wilson_offsets(4) for v in off], 3, 3, *extra)
        want = fn(*args)
    elif name == "permute_4d_tiled":
        from superbblas_tpu_torch.ops.permute import TILES

        op_args = (args[0], [3, 1, 2, 0], TILES[0][0], list(TILES[0][1:]))
        want = (fn(*args),)
    else:
        op_args = (args[0], "bf16x2")
        want = (fn(*args),)
    torch.library.opcheck(op, op_args)
    got = op(*op_args)
    got = got if isinstance(got, tuple) else (got,)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


@pytest.mark.parametrize("op", ["stencil_matvec_soa", "permute_4d", "batched_small_gemm",
                                "batched_gemm_rowpack"])
def test_kernel_custom_ops_pass_opcheck(op):
    """Each kernel's custom op, on CPU tensors (its real implementation is
    the eager call, so the plain version): schema, fake implementation
    and real one agree (``torch.library.opcheck``)."""
    from superbblas_tpu_torch.models import wilson as TW

    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))
    if op == "stencil_matvec_soa":
        lat = (4, 4, 2, 2)
        w = TW.wilson_operator(lat, mass=0.1, key=0, dtype=torch.complex128, layout="soa",
                               device="cpu")
        args = (w.blocks.re, w.blocks.im, w.kron.re, w.kron.im, t(2, 12, *lat),
                t(2, 12, *lat), [v for off in w.offsets for v in off], 3, 3, -1)
    elif op == "permute_4d":
        args = (t(6, 4, 5, 8).float(), [3, 2, 1, 0])
    else:
        args = (t(5, 3, 4), t(5, 4, 2))
    torch.library.opcheck(getattr(torch.ops.sbt, op).default, args)
