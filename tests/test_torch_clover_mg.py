"""superbblas_tpu_torch.models.multigrid's two-level multigrid of the SoA
Wilson-clover operator (no JAX counterpart) against the benchmark's plain
reference (``benchmark/reference/clover_mg.py``: the full clover operator
and the dense Galerkin matrix P^H D P of a given P), on seeded random
SU(3) links at complex128 on the CPU (K1 and the batched-GEMM kernels run
their plain versions here; the card runs them in the benchmark's cell).

The tolerances, each with its reason:

* C128_TOL 1e-12: the probed coarse operator and the dense P^H D P are
  the same sums of a few thousand complex128 terms in another order.
* The solve: |D x - b| / |b| under the reference meets the solve's own
  tolerance (FGCR's residual recurrence at complex128 drifts from the
  true residual by rounding, far below it), and x matches a dense
  ``torch.linalg.solve`` of the reference's D to SOLVE_RTOL = 1e3 x the
  tolerance (the condition number of D at the mass taken is below 100).
"""

import importlib.util
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import collect_garbage, torch_one_thread  # noqa: F401  (fixtures)
from superbblas_tpu_torch import bsr, cplx, solvers
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import multigrid as MG
from superbblas_tpu_torch.models.clover import apply_clover, wilson_clover_operator
from superbblas_tpu_torch.models.coarse import apply_coarse
from superbblas_tpu_torch.ops.stencil import aos_to_soa, soa_to_aos
from superbblas_tpu_torch.utils import tracker

_REF = Path(__file__).resolve().parent.parent / "benchmark" / "reference"
if str(_REF) not in sys.path:
    sys.path.insert(0, str(_REF))
_spec = importlib.util.spec_from_file_location("ref_clover_mg", _REF / "clover_mg.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

CFG = {"mass": -1.0, "c_sw": 1.0}
C128_TOL, TOL, SOLVE_RTOL = 1e-12, 1e-10, 1e-7
BLOCK = (2, 2, 2, 2)


def links(lat, seed=7):
    """Random SU(3) links [4, *lat, 3, 3] complex128."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((2, 4) + lat + (3, 3), generator=g, dtype=torch.float64)
    a = torch.complex(a[0], a[1])
    c0 = a[..., 0] / torch.linalg.vector_norm(a[..., 0], dim=-1, keepdim=True)
    c1 = a[..., 1] - (c0.conj() * a[..., 1]).sum(-1, keepdim=True) * c0
    c1 = c1 / torch.linalg.vector_norm(c1, dim=-1, keepdim=True)
    return torch.stack([c0, c1, torch.linalg.cross(c0.conj(), c1.conj())], dim=-1)


def field(shape, seed=1, dtype=torch.float64) -> CArray:
    g = torch.Generator().manual_seed(seed)
    return CArray(*(torch.randn(shape, generator=g, dtype=dtype) for _ in range(2)))


def c128(c: CArray) -> torch.Tensor:
    return torch.complex(c.re, c.im).to(torch.complex128)


def setup(lat, nvec=3, **kw):
    U = links(lat)
    op = wilson_clover_operator(lat, links=U, layout="soa", device="cpu",
                                dtype=torch.complex128, **CFG)
    kw = dict(dict(setup_rounds=2, setup_steps=4, refine_rounds=1), **kw)
    return U, op, MG.clover_mg_setup(op, block=BLOCK, nvec=nvec, key=11, **kw)


@pytest.fixture(scope="module")
def small():
    """4^3x8 with 2^4 aggregates: a coarse lattice 2x2x2x4 (the +-1
    neighbours of an extent of 2 are one site), 3 test vectors (N_c 6)."""
    return setup((4, 4, 4, 8))


def dense_coarse(mg) -> torch.Tensor:
    """The port's coarse operator as a dense [M, M] matrix, column by
    column through its apply."""
    clat, nc = tuple(mg.P.shape[:4]), 2 * mg.P.shape[-1]
    M = int(np.prod(clat)) * nc
    e = torch.eye(M, dtype=torch.float64).reshape(clat + (nc, M))
    return c128(apply_coarse(mg.coarse, CArray(e, torch.zeros_like(e)))).reshape(M, M)


def basis(mg) -> torch.Tensor:
    """P's columns as fine fields [M, 12, *lat] (complex128)."""
    clat, nc = tuple(mg.P.shape[:4]), 2 * mg.P.shape[-1]
    M = int(np.prod(clat)) * nc
    e = torch.eye(M, dtype=torch.float64).reshape(clat + (nc, M))
    return c128(MG._prolong_chiral(mg.P, CArray(e, torch.zeros_like(e)), mg.block))


def test_probed_coarse_operator_is_the_dense_galerkin_matrix(small):
    U, _op, mg = small
    want = R.galerkin(U, CFG, basis(mg))
    got = dense_coarse(mg)
    assert float((got - want).abs().max() / want.abs().max()) < C128_TOL
    assert mg.coarse.mode == "gather" and mg.coarse.ndir == 6


def test_prolongator_is_chirally_split_and_block_orthonormal(small):
    """P^H P = I on each aggregate; each column lives on one chirality
    (spins 0-1 or 2-3); restriction is prolongation's adjoint."""
    _U, _op, mg = small
    P = c128(mg.P)
    gram = P.transpose(-1, -2).conj() @ P
    assert float((gram - torch.eye(P.shape[-1], dtype=P.dtype)).abs().max()) < C128_TOL
    f = basis(mg).reshape(-1, 4, 3, 4 * 4 * 4 * 8)
    upper = f[:, :2].abs().amax((1, 2, 3)) > 0
    lower = f[:, 2:].abs().amax((1, 2, 3)) > 0
    assert bool((upper ^ lower).all())
    x = field((2, 12, 4, 4, 4, 8), 3)
    c = field(tuple(mg.P.shape[:4]) + (2 * mg.P.shape[-1], 2), 4)
    lhs = torch.vdot(c128(MG._prolong_chiral(mg.P, c, mg.block)).reshape(-1), c128(x).reshape(-1))
    rhs = torch.vdot(c128(c).reshape(-1), c128(MG._restrict_chiral(mg.P, x, mg.block)).reshape(-1))
    assert abs(complex(lhs - rhs)) < C128_TOL * abs(complex(lhs))


def test_mg_fgcr_solves_the_plain_operator():
    """4^4 (dense D fits): |D x - b| / |b| under the reference within the
    tolerance, and x equal to a dense solve of the reference's D."""
    lat = (4, 4, 4, 4)
    U, _op, mg = setup(lat, nvec=2)
    b = field((1, 12) + lat, 5)
    x, rs, k = MG.mg_solve_clover(mg, b, tol=TOL, maxiter=100)
    ref = R.Operator(U, CFG)
    bc, xc = c128(b), c128(x)
    assert float((ref.apply(xc) - bc).norm() / bc.norm()) <= TOL
    n = 12 * 256
    D = ref.apply(torch.eye(n, dtype=torch.complex128).reshape((n, 12) + lat)).reshape(n, n).T
    want = torch.linalg.solve(D, bc.reshape(n)).reshape(xc.shape)
    assert float((xc - want).norm() / want.norm()) < SOLVE_RTOL
    assert 0 < k < 100


@pytest.mark.parametrize("normal", [False, True], ids=["D", "DhD"])
def test_level_apply_of_clover_is_apply_clover(small, normal):
    """``_level_apply`` of an SoA clover operator on canonical fields is
    ``apply_clover`` on the SoA field (D^H = g5 D g5 for the normal)."""
    _U, op, _mg = small
    x = field((4, 4, 4, 8, 4, 3, 2), 6)
    y = apply_clover(op, aos_to_soa(x, 4))
    if normal:
        y = MG._g5(apply_clover(op, MG._g5(y)))
    want = soa_to_aos(y, 4, 4, 3)
    got = MG._level_apply(op, x, normal=normal)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    one = MG._level_apply(op, cplx.cmap(lambda a: a[..., 0], x), normal=normal)
    assert all(torch.equal(g, w[..., 0]) for g, w in zip(one, want))


def test_counters_count_the_outer_solve_alone(small):
    """After a solve: one ``mg.cycles`` an FGCR iteration, the solve's
    iterations alone in ``solver.iterations``, the coarse GCR's in
    ``mg.coarse_iterations``; a recorded solve holds the spans."""
    _U, _op, mg = small
    b = field((1, 12, 4, 4, 4, 8), 8)
    before = tracker.counters()
    tracker.start()
    try:
        _x, _rs, k = MG.mg_solve_clover(mg, b, tol=1e-8, maxiter=200)
    finally:
        rec = tracker.stop()
    after = tracker.counters()

    def grew(name):
        return after.get(name, 0) - before.get(name, 0)

    assert k > 0 and grew("mg.cycles") == k and grew("solver.iterations") == k
    assert grew("mg.coarse_iterations") >= k
    assert rec["counters"]["mg.cycles"] == k
    names = [s[2] for s in rec["spans"]]
    assert names.count("mg.cycle") == k and names.count("mg.coarse") == k
    assert names.count("coarse.apply") == grew("mg.coarse_iterations")


def neighbours(clat, offs):
    return [tuple((c + o) % L for c, o, L in zip(site, off, clat)) for site in
            itertools.product(*map(range, clat)) for off in offs]


@pytest.mark.parametrize("clat", [(8, 8, 8, 16), (2, 2, 2, 4), (4, 4, 4, 4), (1, 2, 3, 5)],
                         ids=lambda v: "x".join(map(str, v)))
def test_colouring_is_distance_two(clat):
    """No coarse site sees two of its neighbours (itself included) in one
    colour; the cell's coarse lattice takes 16 colours."""
    offs = MG._coarse_offsets(clat)
    m, col = MG._colouring(clat, offs)
    col = col.reshape(clat)
    assert col.min() >= 0 and col.max() < m
    nb = np.array([col[s] for s in neighbours(clat, offs)]).reshape(-1, len(offs))
    assert all(len(set(row)) == len(offs) for row in nb)
    if clat == (8, 8, 8, 16):
        assert (m, len(offs)) == (16, 9)


def test_gather_apply_holds_its_block_sums():
    """``bsr._apply_gather`` gives ``cplx.cbilinear``'s bits with the
    blocks' Gauss sums held on the operator, and makes them again after an
    in-place change of the blocks."""
    g = torch.Generator().manual_seed(3)
    V, nnz, n = 16, 3, 4
    blocks = CArray(*(torch.randn((V, nnz, n, n), generator=g) for _ in range(2)))
    jj = torch.randint(0, V, (V, nnz), generator=g)
    gop = bsr.BSROperator(blocks, None, (), (2, 2, 2, 2), bi=(n,), bd=(n,), oim="xyztc",
                          odm="xyztC", mode="gather", blk_i="c", blk_d="C", jj_flat=jj,
                          row_counts=torch.full((V,), nnz, dtype=torch.int32))
    x = CArray(*(torch.randn((2, 2, 2, 2, n, 2), generator=g) for _ in range(2)))

    def plain():
        xg = bsr._reshape(bsr._gather_rows(x, gop, (n, 2)), (V, nnz * n, 2))
        b = CArray(gop.blocks_re, gop.blocks_im)
        y = cplx.cbilinear(lambda bb, xx: torch.einsum("vij,vjn->vin", bb, xx), b, xg)
        return cplx.cmap(lambda a: a.reshape(2, 2, 2, 2, n, 2), y)

    for _ in range(2):
        got = bsr._apply_gather(gop, x)
        assert all(torch.equal(a, b) for a, b in zip(got, plain()))
        gop.blocks_im.mul_(-0.5)


def test_fgcr_reads_each_iteration_and_counts_where_told():
    """``read_each`` stops at the first iteration that meets the tolerance;
    ``counter`` names where the iterations go (none for None)."""
    g = torch.Generator().manual_seed(2)
    A = torch.randn(40, 40, generator=g, dtype=torch.float64) + 8 * torch.eye(40)
    b = torch.randn(40, generator=g, dtype=torch.float64)

    def apply(v):
        return A @ v

    _x, _rs, k_all = solvers.fgcr(apply, b, tol=1e-9, maxiter=200, restart=16)
    before = tracker.counters()
    x, rs, k = solvers.fgcr(apply, b, tol=1e-9, maxiter=200, restart=16, read_each=True,
                            counter="test.fgcr")
    after = tracker.counters()
    assert k <= k_all and k_all % 16 == 0
    assert float(torch.linalg.norm(A @ x - b) / torch.linalg.norm(b)) < 1e-8
    assert after.get("test.fgcr", 0) - before.get("test.fgcr", 0) == k
    assert after.get("solver.iterations", 0) == before.get("solver.iterations", 0)
    _x, _rs, k_prev = solvers.fgcr(apply, b, tol=1e-9, maxiter=k - 1, restart=16,
                                   read_each=True, counter=None)
    assert k_prev == k - 1
    assert tracker.counters().get("solver.iterations", 0) == after.get("solver.iterations", 0)
