"""The domain-wall s5 pass (``superbblas_tpu_torch.ops.dw_s5``) on the CPU:
the mass walls at s = 0 and s = Ls-1, the wrapper on CPU tensors (the
plain version, no launch, no bytes counted), what it refuses, and the
apply's routing of its passes.  The plain version inside the SoA apply is
held against the JAX package and the port's AoS apply
(``tests/test_torch_domain_wall.py``, Ls 1, 4 and 12), the kernel against
the plain version on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import domain_wall as TD
from superbblas_tpu_torch.models import wilson as TW
from superbblas_tpu_torch.ops import dw_s5 as S5
from superbblas_tpu_torch.utils import tracker

LAT = (2, 2, 4, 4)
FAMILIES = {"shamir": ("shamir", "right"), "mobius-right": ("mobius", "right"),
            "mobius-left": ("mobius", "left")}


def operator(family, Ls):
    kind, side = FAMILIES[family]
    links = TW.random_su3_links(np.random.default_rng(4), LAT)
    kw = dict(Ls=Ls, M5=1.8, m_f=0.000678, links=links, dtype=torch.complex64, layout="soa",
              device="cpu")
    if kind == "shamir":
        return TD.domain_wall_operator(LAT, **kw)
    return TD.mobius_operator(LAT, b5=1.5, c5=0.5, projector_side=side, **kw)


def field(n, Ls, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (n, Ls, 12) + LAT
    return CArray(*(torch.from_numpy(rng.standard_normal(shape).astype(dtype))
                    for _ in range(2)))


@pytest.mark.parametrize("bulk,wall", [(-1.0, 0.000678), (1.0, -0.000678)],
                         ids=["shamir", "mobius"])
@pytest.mark.parametrize("Ls", [1, 4, 12])
def test_walls_at_both_ends(Ls, bulk, wall):
    """H x alone (y = 0): the P+ channels 0-5 take x_{s-1} and the P-
    channels 6-11 x_{s+1}, times bulk, and times wall across the s wrap:
    at s = 0 from x_{Ls-1} and at s = Ls-1 from x_0."""
    op = operator("shamir", Ls)
    x = field(2, Ls, seed=3)
    zero = CArray(torch.zeros_like(x.re), torch.zeros_like(x.im))
    out = S5.dw_s5_reference("shamir", x, zero, op.pm_diag, op.pp_diag, bulk, wall)
    for o, a in zip(out, x):
        assert torch.equal(o[:, 0, :6], wall * a[:, Ls - 1, :6])
        assert torch.equal(o[:, Ls - 1, 6:], wall * a[:, 0, 6:])
        if Ls > 1:
            assert torch.equal(o[:, 0, 6:], bulk * a[:, 1, 6:])
            assert torch.equal(o[:, Ls - 1, :6], bulk * a[:, Ls - 2, :6])
            assert torch.equal(o[:, 1:, :6], bulk * a[:, :-1, :6])
            assert torch.equal(o[:, :-1, 6:], bulk * a[:, 1:, 6:])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", S5.PASSES)
def test_wrapper_on_cpu_runs_the_plain_version(kind, dtype):
    op = operator("mobius-right", 4)
    x, y = field(2, 4, seed=5, dtype=dtype), field(2, 4, seed=6, dtype=dtype)
    y = None if kind == "right_pre" else y
    args = (kind, x, y, op.pm_diag, op.pp_diag, 1.0, -op.m_f, 1.5, 0.5)
    launches, nbytes = S5.dw_s5.launches, tracker.counters().get("dw_s5.bytes", 0)
    for a, b in zip(S5.dw_s5(*args), S5.dw_s5_reference(*args)):
        assert a.dtype == x.re.dtype and torch.equal(a, b)
    assert S5.dw_s5.launches == launches
    assert tracker.counters().get("dw_s5.bytes", 0) == nbytes


def _refused():
    x, y = field(1, 4, seed=7), field(1, 4, seed=8)
    w = torch.ones(12)
    return {
        "unknown pass": ("middle", x, y, w, w),
        "right_pre with y": ("right_pre", x, y, w, w),
        "left without y": ("left", x, None, w, w),
        "f16 planes": ("shamir", CArray(*(t.half() for t in x)), CArray(*(t.half() for t in y)),
                       w, w),
        "f64 y beside f32 x": ("shamir", x, CArray(*(t.double() for t in y)), w, w),
        "y of another Ls": ("right_post", x, field(1, 3), w, w),
        "not 12 channels": ("shamir", CArray(*(t[:, :, :6] for t in x)),
                            CArray(*(t[:, :, :6] for t in y)), w, w),
        "weights of 6": ("left", x, y, w, w[:6]),
        "weights on another device": ("left", x, y, w, w.to("meta")),
        "fields on another device": ("shamir", CArray(*(t.to("meta") for t in x)),
                                     CArray(*(t.to("meta") for t in y)), w.to("meta"),
                                     w.to("meta")),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError, match="dw_s5"):
        S5.dw_s5(*_refused()[case], 1.0, -0.1)


@pytest.mark.parametrize("family,passes", [("shamir", ["shamir"]),
                                           ("mobius-right", ["right_pre", "right_post"]),
                                           ("mobius-left", ["left"])])
def test_apply_routes_its_passes_to_the_wrapper(family, passes, monkeypatch):
    """Every s5 term of an apply is one ``dw_s5`` call, with the
    operator's weights and scalars; the result is the wrapper's."""
    op = operator(family, 4)
    x = field(1, 4, seed=9)
    plain = TD.apply_domain_wall(op, x)
    seen = []

    def wrapper(kind, *args):
        seen.append(kind)
        return S5.dw_s5_reference(kind, *args)

    monkeypatch.setattr(S5, "dw_s5", wrapper)
    routed = [TD.apply_domain_wall(op, x) for _ in range(2)]
    assert seen == passes * 2
    for a, b in zip(routed[0], plain):
        assert torch.equal(a, b)
