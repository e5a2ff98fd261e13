"""superbblas_tpu_torch.models.clover_eo (the even-odd preconditioned
Wilson-clover operator on packed half lattices) against the benchmark's
plain reference (``benchmark/reference/clover_eo.py``: the Schur
complement from checkerboard masks on the unpacked lattice, A_oo^-1 by a
complex128 solve on each site's block) on seeded random SU(3) links at
4^3x8 and 8^4, on the CPU (the stencil's plain version; K1 itself runs on
the card in ``chip_smoke.py``).

The tolerances, each with its reason; ``test_tf32_fails_the_tolerances``
shows that a TF32-rounded computation (every operand of a product rounded
to 10 mantissa bits, a relative error near 2^-11) fails each:

* C128_TOL 1e-12: complex128 sums of a few hundred terms and a 12x12
  inverse of condition below 10 (A = 4.1 + clover term at c_sw 1): the
  port and the reference differ by rounding alone, near 1e-15.
* F32_TOL 2e-6 (of the largest magnitude): float32 blocks and fields,
  sums of up to 9 x 12 terms a launch over four launches (measured
  2.6e-7); TF32 rounding gives some 1e-4.
* INV_F32_TOL 1e-6: A_oo^-1 cast from complex128 to complex64, one
  rounding of each entry (2^-24 of entries near 0.3) summed over 12
  products of entries near 4.
* The solve: the true Schur residual of the returned x_e meets the
  solve's own test, |Dhat^H r_e| <= tol |Dhat^H bhat| (the recursive
  residual of CG drifts from the true one by rounding: SOLVE_SLACK 1.5
  at complex64); the full residual's odd rows vanish (C128_TOL), because
  x_o solves them site by site.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from _torch_parity import collect_garbage, torch_one_thread  # noqa: F401  (fixtures)
from superbblas_tpu_torch import solvers
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import clover_eo as E
from superbblas_tpu_torch.models.clover import wilson_clover_operator
from superbblas_tpu_torch.models.eo_packed import cb_pack_soa, cb_unpack_soa
from superbblas_tpu_torch.utils import tracker

_REF = Path(__file__).resolve().parent.parent / "benchmark" / "reference"
if str(_REF) not in sys.path:
    sys.path.insert(0, str(_REF))
from ref_wilson import tf32  # noqa: E402

_spec = importlib.util.spec_from_file_location("ref_clover_eo", _REF / "clover_eo.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

LATS = [(4, 4, 4, 8), (8, 8, 8, 8)]
CFG = {"mass": 0.1, "c_sw": 1.0}
C128_TOL, F32_TOL, INV_F32_TOL, SOLVE_SLACK = 1e-12, 2e-6, 1e-6, 1.5
C128, C64 = torch.complex128, torch.complex64
PARTS = {C128: torch.float64, C64: torch.float32}


def links(lat, seed=7):
    """Random SU(3) links [4, *lat, 3, 3] complex128 (Gram-Schmidt of
    Gaussian columns, the third the conjugate cross product)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((2, 4) + lat + (3, 3), generator=g, dtype=torch.float64)
    a = torch.complex(a[0], a[1])
    c0 = a[..., 0] / torch.linalg.vector_norm(a[..., 0], dim=-1, keepdim=True)
    c1 = a[..., 1] - (c0.conj() * a[..., 1]).sum(-1, keepdim=True) * c0
    c1 = c1 / torch.linalg.vector_norm(c1, dim=-1, keepdim=True)
    return torch.stack([c0, c1, torch.linalg.cross(c0.conj(), c1.conj())], dim=-1)


def field(lat, n, dtype, seed=1) -> CArray:
    g = torch.Generator().manual_seed(seed)
    return CArray(*(torch.randn((n, 12) + lat, generator=g, dtype=PARTS[dtype])
                    for _ in range(2)))


def cplx128(c: CArray) -> torch.Tensor:
    return torch.complex(c.re, c.im).to(C128)


def zeros_like(c: CArray) -> CArray:
    return CArray(torch.zeros_like(c.re), torch.zeros_like(c.im))


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def build(lat, dtype, seed=7):
    U = links(lat, seed)
    op = wilson_clover_operator(lat, links=U, layout="soa", device="cpu", dtype=dtype, **CFG)
    return U, E.clover_eo_operator(op)


def port_schur_full(eo, v: CArray) -> torch.Tensor:
    """The port's Dhat on the even part of the full field ``v``, unpacked
    (zero on the odd sites), complex128."""
    y = E.apply_schur(eo, cb_pack_soa(v, 0))
    return cplx128(cb_unpack_soa(y, zeros_like(y)))


@pytest.mark.parametrize("lat", LATS, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("dtype, tol", [(C128, C128_TOL), (C64, F32_TOL)], ids=["c128", "c64"])
def test_schur_matches_reference(lat, dtype, tol):
    U, eo = build(lat, dtype)
    v = field(lat, 2, dtype)
    want = R.schur(U, CFG)(cplx128(v))
    assert rel(port_schur_full(eo, v), want) < tol


def site_blocks(U, lat, parity) -> torch.Tensor:
    """The reference's A = (m + 4 r) + clover term on the ``parity`` sites
    in the packed order, [V/2, 12, 12] complex128."""
    C = R.Operator(U, CFG).C.reshape((1, 144) + lat)
    packed = cb_pack_soa(CArray(C.real.contiguous(), C.imag.contiguous()), parity)
    A = cplx128(packed).reshape(12, 12, -1).permute(2, 0, 1)
    return A + (CFG["mass"] + 4.0) * torch.eye(12, dtype=C128)


def blocks_of(site_op) -> torch.Tensor:
    return cplx128(site_op.blocks).reshape(12, 12, -1).permute(2, 0, 1)


@pytest.mark.parametrize("lat", LATS, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("dtype, tol", [(C128, C128_TOL), (C64, INV_F32_TOL)],
                         ids=["c128", "c64"])
def test_odd_site_blocks_times_their_inverse_is_one(lat, dtype, tol):
    U, eo = build(lat, dtype)
    eye = torch.eye(12, dtype=C128)
    assert float((site_blocks(U, lat, 1) @ blocks_of(eo.site_o_inv) - eye).abs().max()) < tol
    # the even blocks are A itself, in the blocks' type
    assert rel(blocks_of(eo.site_e), site_blocks(U, lat, 0)) < tol


@pytest.mark.parametrize("lat", LATS, ids=lambda v: "x".join(map(str, v)))
def test_schur_adjoint_is_g5_schur_g5(lat):
    """<u, Dhat v> = <g5 Dhat g5 u, v>: Dhat^H = g5 Dhat g5, which the
    solve takes for its adjoint."""
    _, eo = build(lat, C128)
    u, v = (cb_pack_soa(field(lat, 2, C128, seed), 0) for seed in (2, 3))
    g5u = E._g5(eo, E.apply_schur(eo, E._g5(eo, u)))
    lhs = torch.vdot(cplx128(u).reshape(-1), cplx128(E.apply_schur(eo, v)).reshape(-1))
    rhs = torch.vdot(cplx128(g5u).reshape(-1), cplx128(v).reshape(-1))
    assert abs(complex(lhs - rhs)) < C128_TOL * abs(complex(lhs))


@pytest.mark.parametrize("lat", LATS, ids=lambda v: "x".join(map(str, v)))
def test_packing_matches_the_checkerboard_masks(lat):
    """Data movement only, so exact: a packed parity unpacked beside zeros
    is the field under that parity's mask, and the two parities unpack to
    the field."""
    v = field(lat, 2, C64)
    p = R.parity(lat, "cpu").reshape((1, 1) + lat)
    for parity in (0, 1):
        packed = cb_pack_soa(v, parity)
        assert packed.re.shape[2] == lat[0] // 2
        z = zeros_like(packed)
        full = cb_unpack_soa(packed, z) if parity == 0 else cb_unpack_soa(z, packed)
        for got, want in zip(full, v):
            assert torch.equal(got, torch.where(p == parity, want, torch.zeros_like(want)))
    both = cb_unpack_soa(cb_pack_soa(v, 0), cb_pack_soa(v, 1))
    assert torch.equal(both.re, v.re) and torch.equal(both.im, v.im)


def schur_residuals(U, x: CArray, b: CArray, lat):
    """By the reference in complex128: (|Dhat^H r_e| / |Dhat^H bhat|, the
    full residual D x - b, r_e = bhat - Dhat x_e).  bhat = b_e - H_eo
    A_oo^-1 b_o is the even part of b - D y, y = A_oo^-1 b_o on the odd
    sites and zero on the even ones."""
    D, S = R.Operator(U, CFG), R.schur(U, CFG)
    xc, bc = cplx128(x), cplx128(b)
    even = (R.parity(lat, "cpu") == 0).reshape((1, 1) + lat)
    bo = cplx128(cb_pack_soa(b, 1))
    n = bo.shape[0]
    yo = torch.linalg.solve(site_blocks(U, lat, 1), bo.reshape(n, 12, -1).permute(2, 1, 0))
    yo = yo.permute(2, 1, 0).reshape(bo.shape)
    yo = CArray(yo.real.contiguous(), yo.imag.contiguous())
    y = cplx128(cb_unpack_soa(zeros_like(yo), yo))
    bhat = torch.where(even, bc - D.apply(y), 0)
    r_e = bhat - S(torch.where(even, xc, 0))

    def normal(t):
        return float(D._g5(S(D._g5(t))).norm())

    return normal(r_e) / normal(bhat), D.apply(xc) - bc, r_e


@pytest.mark.parametrize("dtype, tol", [(C128, 1e-9), (C64, 1e-5)], ids=["c128", "c64"])
def test_full_solution_solves_d(dtype, tol):
    """The reconstructed x solves D x = b as far as the Schur solve goes:
    the odd rows of D x - b vanish, the even rows are minus the Schur
    residual, and that meets the solve's test."""
    lat = LATS[0]
    U, eo = build(lat, dtype)
    b = field(lat, 2, dtype, seed=5)
    x, rs, k = E.eo_solve_clover_soa(eo, b, tol=tol, maxiter=500)
    assert 0 < k < 500 and tuple(x.re.shape) == tuple(b.re.shape)
    normal, r, r_e = schur_residuals(U, x, b, lat)
    assert normal <= (1.0 if dtype == C128 else SOLVE_SLACK) * tol
    odd = (R.parity(lat, "cpu") == 1).reshape((1, 1) + lat)
    bn, limit = float(cplx128(b).norm()), C128_TOL if dtype == C128 else F32_TOL
    assert float(torch.where(odd, r, 0).norm()) < limit * bn
    assert float((torch.where(odd, 0, r) + r_e).norm()) < limit * bn


def test_tf32_fails_the_tolerances():
    lat = LATS[0]
    U, eo = build(lat, C64)
    v = field(lat, 2, C64)
    want = R.schur(U, CFG)(cplx128(v))
    rounded = R.schur(U, CFG, dtype=C64, q=tf32)(torch.complex(v.re, v.im)).to(C128)
    assert rel(port_schur_full(eo, v), want) < F32_TOL < rel(rounded, want)
    inv = blocks_of(eo.site_o_inv).to(C64)
    inv = torch.complex(tf32(inv.real.contiguous()), tf32(inv.imag.contiguous())).to(C128)
    err = float((site_blocks(U, lat, 1) @ inv - torch.eye(12, dtype=C128)).abs().max())
    assert err > INV_F32_TOL
    # a solve whose hopping and site blocks are TF32-rounded misses the tolerance
    def rnd(op):
        return op.replace(blocks=CArray(tf32(op.blocks_re), tf32(op.blocks_im)))

    coarse = E.CloverEOOperator(rnd(eo.hop_e), rnd(eo.hop_o), rnd(eo.site_e),
                                rnd(eo.site_o_inv), eo.signs)
    b = field(lat, 2, C64, seed=5)
    x, _, _ = E.eo_solve_clover_soa(coarse, b, tol=1e-5, maxiter=500)
    normal, _, _ = schur_residuals(U, x, b, lat)
    assert normal > SOLVE_SLACK * 1e-5


def test_spans_and_counter_while_a_record_is_open():
    lat = LATS[0]
    _, eo = build(lat, C64)
    b = field(lat, 1, C64)
    before = tracker.counters().get("schur.applies", 0)
    tracker.start()
    try:
        _, _, k = E.eo_solve_clover_soa(eo, b, tol=1e-5, maxiter=500)
    finally:
        rec = tracker.stop()
    names = [s[2] for s in rec["spans"]]
    spans = {s[0]: s for s in rec["spans"]}
    # A^H bhat, then Dhat and Dhat^H an iteration
    assert names.count("apply_schur") == rec["counters"]["schur.applies"] == 2 * k + 1
    assert names.count("eo.prepare") == names.count("eo.reconstruct") == 1
    for s in rec["spans"]:
        if s[2] == "apply_schur":
            assert spans[s[1]][2] == "solver.cg"
        elif s[2] in ("eo.prepare", "eo.reconstruct"):
            assert s[1] is None and s[5] is None          # host spans
    assert tracker.counters()["schur.applies"] - before == 2 * k + 1
    # with no record open nothing is kept; the counter still counts
    E.apply_schur(eo, cb_pack_soa(b, 0))
    assert tracker.stop() == {"spans": [], "counters": {}}
    assert tracker.counters()["schur.applies"] - before == 2 * k + 2


def test_one_system_of_f32_fields_takes_the_fused_cg_loop(monkeypatch):
    """``solvers._fusable`` asks for split-complex f32 planes on a CUDA
    device, contiguous and of one shape: the Schur solve's operands are
    such planes (the device aside; K1's outputs are contiguous on the card,
    as the stand-in below makes the plain version's), and with the device
    check lifted every iteration runs on the fused loop (its kernels' plain
    versions here)."""
    lat = LATS[0]
    _, eo = build(lat, C64)
    b = field(lat, 2, C64)
    want = E.eo_solve_clover_soa(eo, b, tol=1e-5, maxiter=500)
    stencil = E.apply_stencil_soa
    monkeypatch.setattr(E, "apply_stencil_soa", lambda *a, **k: CArray(
        *(t.contiguous() for t in stencil(*a, **k))))
    seen = []

    def fusable_on_any_device(rhs, x0, cols):
        seen.append(not cols and x0 is None and all(
            t.dtype == torch.float32 and t.is_contiguous() and t.shape == rhs.re.shape
            for t in rhs))
        return True

    monkeypatch.setattr(solvers, "_fusable", fusable_on_any_device)
    c = tracker.counters()
    x, _, k = E.eo_solve_clover_soa(eo, b, tol=1e-5, maxiter=500)
    after = tracker.counters()
    assert seen == [True] and k == want[2]
    assert after["solver.fused_iterations"] - c.get("solver.fused_iterations", 0) == k
    assert after["solver.iterations"] - c.get("solver.iterations", 0) == k
    assert rel(cplx128(x), cplx128(want[0])) < 1e-4


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                                world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        if made:
            dist.destroy_process_group()


def test_dtensor_operands_are_refused(one_rank_mesh):
    from torch.distributed.tensor import DTensor, Shard

    lat = LATS[0]
    _, eo = build(lat, C64)
    b = field(lat, 1, C64)
    def shard(c):
        return CArray(*(DTensor.from_local(p, one_rank_mesh, [Shard(2)]) for p in c))

    b_e = cb_pack_soa(b, 0)
    calls = {"apply_schur": lambda: E.apply_schur(eo, shard(b_e)),
             "eo_prepare": lambda: E.eo_solve_clover_soa(eo, shard(b)),
             "eo_reconstruct": lambda: E.eo_reconstruct(eo, b_e, shard(b))}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name}: the clover even-odd path runs on one"):
            call()
