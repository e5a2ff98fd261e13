"""CG's fused vector updates (``ops/cg_update.py``) and the loop of
``solvers.cg`` that runs on them, on the CPU.

The plain versions give the steps the PyTorch ops of ``solvers.cg`` give
(``_axpy_c``, ``_inner_r``), within 2 f32 ulps, at lengths with and
without a tail of n % 4, in place and not.  The fused loop, forced onto
CPU operands (``solvers._fusable``: the wrappers then run the plain
versions), takes the iterations of the PyTorch loop with the same
results and leaves ``b`` and ``x0`` unchanged; operands the kernels do not
take keep the PyTorch loop and count no fused iteration.  On a gloo group
of 4 processes, a Wilson CGNE on X-sharded DTensor fields runs the fused
loop (each partial sum all-reduced) to the PyTorch loop's result and to
the unsharded solve's.  The kernels themselves run on the card
(``tests/test_torch_cuda.py -k cg_update``)."""

import numpy as np
import pytest
import torch

from _torch_dist import run_group
from superbblas_tpu_torch import solvers
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import wilson as W
from superbblas_tpu_torch.ops import cg_update as U
from superbblas_tpu_torch.utils import tracker

LENGTHS = [1, 3, 7, 8, 64, 4099, 4100]


def crand(n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return CArray(*(torch.from_numpy(rng.standard_normal(n)).to(dtype) for _ in range(2)))


def scalar(v):
    return torch.tensor(v, dtype=torch.float32)


def assert_ulps(got, want, ulps=2):
    """|got - want| within ``ulps`` f32 ulps of the larger, elementwise."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    room = ulps * np.spacing(np.maximum(np.abs(g), np.abs(w)))
    assert np.all(np.abs(g.astype(np.float64) - w) <= room), np.max(np.abs(g - w))


def clone(c):
    return CArray(c.re.clone(), c.im.clone())


def operands(n):
    """x, p, r and q = A p of a positive A: 1.5 p plus a little noise."""
    x, p, r, e = (crand(n, s) for s in range(4))
    return x, p, r, CArray(1.5 * p.re + 0.1 * e.re, 1.5 * p.im + 0.1 * e.im)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_versions_give_the_steps_of_the_pytorch_ops(n, in_place):
    x, p, r, q = operands(n)
    rs, pap, bs = solvers._inner_r(r, r), solvers._inner_r(p, q), scalar(3.5)
    assert_ulps(U.cg_dot_reference(p, q), pap)
    alpha = rs / torch.clamp_min(pap, 1e-30)
    want_x = solvers._axpy_c((alpha, 0.0 * alpha), p, x)
    want_r = solvers._axpy_c((-alpha, 0.0 * alpha), q, r)
    x_out, r_out = (clone(x), clone(r)) if in_place else (crand(n, 8), crand(n, 9))
    rs_new = U.cg_xr_reference(x_out if in_place else x, p, r_out if in_place else r, q, rs,
                               pap, x_out, r_out)
    for got, want in zip((*x_out, *r_out), (*want_x, *want_r)):
        assert_ulps(got, want)
    assert_ulps(rs_new, solvers._inner_r(want_r, want_r))
    beta = rs_new / torch.clamp_min(rs, 1e-30)
    want_p = solvers._axpy_c((beta, 0.0 * beta), p, r_out)
    p_out = clone(p) if in_place else crand(n, 10)
    ratio = U.cg_p_reference(r_out, p_out if in_place else p, rs_new, rs, bs, p_out)
    for got, want in zip(p_out, want_p):
        assert_ulps(got, want)
    assert_ulps(ratio, rs_new / bs)


@pytest.mark.parametrize("n", LENGTHS)
def test_wrappers_on_cpu_run_the_plain_versions(n):
    x, p, r, q = operands(n)
    rs, pap, bs = U.cg_dot(r, r), U.cg_dot(p, q), scalar(2.0)
    assert torch.equal(rs, U.cg_dot_reference(r, r))
    outs = [crand(n, 5), crand(n, 6), crand(n, 7), crand(n, 8), crand(n, 9)]
    got = U.cg_xr(x, p, r, q, rs, pap, outs[0], outs[1])
    want = U.cg_xr_reference(x, p, r, q, rs, pap, outs[2], outs[3])
    assert torch.equal(got, want)
    for a, b in zip((*outs[0], *outs[1]), (*outs[2], *outs[3])):
        assert torch.equal(a, b)
    ratio = U.cg_p(outs[1], p, got, rs, bs, outs[4])
    assert torch.equal(ratio, got / bs)


@pytest.mark.parametrize("case", ["sizes", "f64", "strided", "scalar_shape", "scalar_f64"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    p, q = crand(16, 0), crand(16, 1)
    rs = pap = scalar(1.0)
    if case == "sizes":
        q = crand(12, 1)
    elif case == "f64":
        q = crand(16, 1, torch.float64)
    elif case == "strided":
        q = CArray(torch.zeros(32)[::2], torch.zeros(16))
    elif case == "scalar_shape":
        rs = torch.ones(1)
    else:
        pap = torch.tensor(1.0, dtype=torch.float64)
    with pytest.raises(ValueError):
        if case.startswith("scalar"):
            U.cg_xr(p, p, p, q, rs, pap, clone(p), clone(p))
        else:
            U.cg_dot(p, q)


def test_form_follows_the_alignment():
    t = torch.zeros(64)
    assert t.data_ptr() % 16 == 0
    assert U.form(t, t[4:]) == "vec16"
    assert U.form(t, t[1:]) == "elem"           # a 4-byte offset view
    assert U.FORMS.index("vec16") == 1 and U.FORMS.index("elem") == 0


def _hpd(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    mt = torch.from_numpy((m @ m.conj().T / n + np.eye(n)).astype(np.complex64))

    def A(v):
        z = mt @ torch.complex(v.re.reshape(-1), v.im.reshape(-1))
        return CArray(z.real.reshape(v.re.shape).contiguous(),
                      z.imag.reshape(v.re.shape).contiguous())

    return A


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("n", [37, 96])
def test_fused_loop_takes_the_pytorch_loops_steps(monkeypatch, n, x0):
    """The fused loop (forced onto CPU operands) against the PyTorch loop:
    the same iterations, residual history and solution; ``b`` and ``x0``
    unchanged; each iteration counted in ``solver.fused_iterations``."""
    A, b = _hpd(n, n), crand(n, 1)
    start = crand(n, 2) if x0 else None
    keep = [clone(b)] + ([clone(start)] if x0 else [])
    hist_ops, hist_fused = [], []
    want = solvers.cg(A, b, x0=start, tol=1e-6, maxiter=200, callback=hist_ops.append)
    monkeypatch.setattr(solvers, "_fusable", lambda *args: True)
    before = tracker.counters().get("solver.fused_iterations", 0)
    got = solvers.cg(A, b, x0=start, tol=1e-6, maxiter=200, callback=hist_fused.append)
    assert got[2] == want[2] > 3
    assert tracker.counters()["solver.fused_iterations"] - before == got[2]
    assert torch.equal(got[1], want[1])
    assert [float(v) for v in hist_fused] == [float(v) for v in hist_ops]
    for a, w in zip(got[0], want[0]):
        assert torch.equal(a, w)
    for kept, now in zip(keep, [b] + ([start] if x0 else [])):
        assert torch.equal(kept.re, now.re) and torch.equal(kept.im, now.im)


#: operands of ``_fusable`` on fake CUDA tensors: (b planes, x0 planes, cols)
#: -> whether the fused loop takes them
FUSABLE = {
    "f32": ((16, None), None, False, True),
    "f32_x0": ((16, None), (16, None), False, True),
    "cols": ((16, None), None, True, False),
    "plain": ("plain", None, False, False),
    "f64": ((16, torch.float64), None, False, False),
    "strided": ((16, "strided"), None, False, False),
    "x0_size": ((16, None), (8, None), False, False),
}


def _fake_planes(spec):
    from torch._subclasses.fake_tensor import FakeTensorMode

    n, kind = spec
    with FakeTensorMode(allow_non_fake_inputs=True):
        if kind == "strided":
            return [torch.empty_strided((n,), (2,), device="cuda") for _ in range(2)]
        return [torch.empty(n, device="cuda", dtype=kind or torch.float32) for _ in range(2)]


@pytest.mark.parametrize("case", list(FUSABLE))
def test_the_kernels_take_one_system_of_contiguous_f32_cuda_fields(case):
    """``_fusable`` at fake CUDA operands (no card needed): split-complex
    f32 contiguous planes of one shape, one system; nothing else."""
    b, x0, cols, want = FUSABLE[case]
    if b == "plain":
        b = _fake_planes((16, None))[0]
    else:
        b = CArray(*_fake_planes(b))
    x0 = None if x0 is None else CArray(*_fake_planes(x0))
    assert solvers._fusable(b, x0, cols) == want


@pytest.mark.parametrize("case", ["cols", "plain", "cpu"])
def test_other_operands_keep_the_pytorch_loop(case):
    """``cols=True``, plain real tensors and CPU fields take the PyTorch
    loop and count no fused iteration."""
    n = 24
    A = _hpd(n, 3)
    b, cols = crand(n, 4), False
    if case == "cols":
        b, cols = CArray(b.re.reshape(n // 3, 3), b.im.reshape(n // 3, 3)), True
        A = lambda v: CArray(2.0 * v.re, 2.0 * v.im)  # noqa: E731
    elif case == "plain":
        m = torch.from_numpy(np.diag(np.arange(1.0, n + 1)).astype(np.float32))
        b, A = b.re, (lambda v: m @ v)
    assert not solvers._fusable(b, None, cols)
    before = tracker.counters().get("solver.fused_iterations", 0)
    _x, _rs, k = solvers.cg(A, b, tol=1e-6, maxiter=100, cols=cols)
    assert k > 0
    assert tracker.counters().get("solver.fused_iterations", 0) == before


# ---------------------------------------------------------------------------
# sharded: four gloo ranks

LAT = (8, 4, 4, 4)
SHARDED = dict(mesh=((4,), ("X",)), lat=LAT, mass=0.2, key=3,
               spec=(None, None, "X", None, None, None), tol=1e-5, maxiter=200)


def _b():
    rng = np.random.default_rng(11)
    return tuple(rng.standard_normal((1, 12) + LAT).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cg_update")
    return run_group("cg_update", [("fused-cgne", "fused_cgne", dict(SHARDED, b=_b()))], tmp)


def test_sharded_fused_cgne_matches_the_unsharded_solve(group):
    """Each rank's fused solve equals its PyTorch-loop solve (the same
    local sums, all-reduced alike), counts its iterations as fused, leaves
    ``b`` as it was and returns a replicated |r|^2; both match the
    unsharded solve within f32 rounding of the sums' other order."""
    op = W.wilson_operator(LAT, mass=SHARDED["mass"], key=SHARDED["key"],
                           dtype=torch.complex64, layout="soa", device="cpu")
    oph = W.adjoint_operator(op)
    b = _b()
    x, rs, k = solvers.cgne(lambda v: W.apply_wilson(op, v), lambda v: W.apply_wilson(oph, v),
                            CArray(torch.from_numpy(b[0]), torch.from_numpy(b[1])),
                            tol=SHARDED["tol"], maxiter=SHARDED["maxiter"])
    want = x.re.double().numpy() + 1j * x.im.double().numpy()
    for got in group.case("fused-cgne"):
        fused, ops = got["fused"], got["ops"]
        assert fused["k"] == ops["k"] == fused["fused"] == k
        assert ops["fused"] == 0
        assert fused["rs"] == ops["rs"]
        assert "Replicate" in fused["rs_placements"]
        np.testing.assert_array_equal(fused["x"][0], ops["x"][0])
        np.testing.assert_array_equal(fused["x"][1], ops["x"][1])
        np.testing.assert_array_equal(got["b"][0], b[0])
        np.testing.assert_array_equal(got["b"][1], b[1])
        x_fused = fused["x"][0] + 1j * fused["x"][1]
        np.testing.assert_allclose(x_fused, want, rtol=0, atol=1e-4 * np.abs(want).max())
        assert fused["rs"] == pytest.approx(float(rs), rel=1e-2)
