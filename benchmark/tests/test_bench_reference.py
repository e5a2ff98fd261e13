"""The plain references against the port at small sizes on the CPU, and
their adjoints; the control's TF32 rounding."""

import pytest
import torch

import gen
import harness
from ref_wilson import tf32
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models.clover import apply_clover, wilson_clover_operator
from superbblas_tpu_torch.models.domain_wall import apply_domain_wall, mobius_operator

LAT = (4, 4, 4, 4)
C128 = torch.complex128
CLOVER = {"mass": 0.1, "c_sw": 1.0}
MOBIUS = {"Ls": 4, "M5": 1.8, "b5": 1.5, "c5": 0.5, "m_f": 0.000678}


def field(seed, index, lead):
    re, im = gen.source(seed, index, lead, range(LAT[0]), LAT[1:], "cpu")
    return re, im


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 3])
def test_clover_reference_matches_port(seed):
    U = gen.links(seed, range(LAT[0]), LAT[1:], "cpu")
    op = wilson_clover_operator(LAT, links=U, layout="soa", device="cpu", **CLOVER)
    ref = harness.module("reference", "clover").Operator(U, CLOVER)
    re, im = field(seed, 0, (2, 12))
    y = apply_clover(op, CArray(re, im))
    # float32 sums of up to 252 terms against complex128
    assert rel(torch.complex(y.re, y.im).to(C128), ref.apply(torch.complex(re, im))) < 2e-6
    u = torch.complex(*field(seed, 1, (2, 12))).to(C128)
    v = torch.complex(re, im).to(C128)
    lhs, rhs = torch.vdot(u.reshape(-1), ref.apply(v).reshape(-1)), \
        torch.vdot(ref.adjoint(u).reshape(-1), v.reshape(-1))
    assert abs(complex(lhs - rhs)) < 1e-10 * abs(complex(lhs))


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 3])
def test_mobius_reference_matches_port(seed):
    U = gen.links(seed, range(LAT[0]), LAT[1:], "cpu")
    kw = dict(links=U, dtype=torch.complex64, layout="soa", device="cpu", **MOBIUS)
    ref = harness.module("reference", "mobius").Operator(U, MOBIUS)
    re, im = field(seed, 0, (2, 4, 12))
    v = torch.complex(re, im).to(C128)
    y = apply_domain_wall(mobius_operator(LAT, **kw), CArray(re, im))
    assert rel(torch.complex(y.re, y.im).to(C128), ref.apply(v)) < 2e-6
    # the port's adjoint partner, (g5 R5) D_left (g5 R5), against the reference's own D^H
    s = torch.tensor([1.0] * 6 + [-1.0] * 6).reshape(1, 1, 12, 1, 1, 1, 1)
    r5g5 = lambda c: CArray(*(a.flip(1) * s for a in c))  # noqa: E731
    ya = r5g5(apply_domain_wall(mobius_operator(LAT, projector_side="left", **kw),
                                r5g5(CArray(re, im))))
    assert rel(torch.complex(ya.re, ya.im).to(C128), ref.adjoint(v)) < 2e-6
    u = torch.complex(*field(seed, 1, (2, 4, 12))).to(C128)
    lhs, rhs = torch.vdot(u.reshape(-1), ref.apply(v).reshape(-1)), \
        torch.vdot(ref.adjoint(u).reshape(-1), v.reshape(-1))
    assert abs(complex(lhs - rhs)) < 1e-10 * abs(complex(lhs))


def test_links_are_special_unitary_and_made_by_plane():
    U = gen.links(5, [3, 0, 1], (2, 2, 2), "cpu")
    eye = torch.eye(3, dtype=C128)
    assert float((U @ U.transpose(-1, -2).conj() - eye).abs().max()) < 1e-13
    assert float((torch.linalg.det(U) - 1).abs().max()) < 1e-13
    assert torch.equal(U[:, 0], gen.links(5, [3], (2, 2, 2), "cpu")[:, 0])
    re, _ = gen.source(5, 7, (1, 12), [2, 3], (2, 2, 2), "cpu")
    assert torch.equal(re[:, :, 1], gen.source(5, 7, (1, 12), [3], (2, 2, 2), "cpu")[0][:, :, 0])


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10, -3.14159265,
                      1e-30], dtype=torch.float32)
    y = tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)
    assert float(((y - x) / x).abs().max()) <= 2 ** -11
