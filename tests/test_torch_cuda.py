"""The CUDA kernels on the card: the cases each refuses, the CG solve
through the stencil kernel against the same solve on the CPU, and the
permute kernel against its plain version, alone and inside ``local_copy``.
The kernels at the main path's shapes are checked by ``chip_smoke.py``.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from superbblas_tpu_torch import local_copy
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import wilson as W
from superbblas_tpu_torch.ops import permute as P
from superbblas_tpu_torch.ops import stencil as S

OFFSETS = W.wilson_offsets(4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def crand(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    return CArray(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                    .to(device=device, dtype=dtype) for _ in range(2)))


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    blocks = crand((9, 9, 2, 2, 4, 8), 0, cuda_device, torch.float32)
    x = crand((1, 3, 2, 2, 4, 8), 1, cuda_device, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.stencil_matvec_soa(blocks, None, x, OFFSETS, 3, 3, packed_parity=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.stencil_matvec_soa(blocks.to(torch.float64), None, x.to(torch.float64),
                             OFFSETS, 3, 3)


@pytest.mark.cuda
def test_cg_solve_on_card_matches_cpu(cuda_device):
    """The solve through the kernel against the same solve on the CPU
    (plain version); CG amplifies summation-order differences: rtol 1e-4."""
    lat = (2, 4, 8, 16)
    op = W.wilson_operator(lat, mass=0.1, key=0, device="cpu")
    b = crand((2, 12) + lat, 3, "cpu", torch.float32)
    x_cpu, rs_cpu = W.cg_solve(op, b, n_iters=10)
    before = S.stencil_matvec_soa.launches
    x_gpu, rs_gpu = W.cg_solve(op.to(cuda_device), b.to(cuda_device), n_iters=10)
    assert S.stencil_matvec_soa.launches == before + 21
    scale = float(x_cpu.re.abs().max())
    for g, c in zip(x_gpu, x_cpu):
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * scale
    assert abs(float(rs_gpu) - float(rs_cpu)) <= 1e-4 * float(rs_cpu)


@pytest.mark.cuda
def test_permute_kernel_raises_on_what_it_does_not_take(cuda_device):
    x = torch.zeros((16, 8, 8, 32), device=cuda_device)
    for bad, perm in ((x.double(), (3, 2, 1, 0)), (x, (0, 1, 2, 3)),
                      (x[:1], (3, 2, 1, 0)), (x[0], (2, 1, 0))):
        with pytest.raises(ValueError, match="the kernel takes"):
            P.permute_4d(bad, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("perm", [(3, 2, 1, 0), (3, 1, 2, 0)])
def test_permute_kernel_matches_plain_version(cuda_device, perm):
    """Bit-exact on ragged tiles (X, T not multiples of 32), on a strided
    view and on int32 data; each eligible call launches the kernel once."""
    x = torch.randn((45, 6, 7, 70), device=cuda_device)
    cases = (x, x[3:40, 1:5, 2:7, 5:66], x.view(torch.int32))
    before = P.permute_4d.launches
    for v in cases:
        got = P.maybe_permute(v, perm)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(got, P.permute_4d_reference(v, perm))
    assert P.permute_4d.launches == before + len(cases)


@pytest.mark.cuda
def test_local_copy_on_card_matches_cpu(cuda_device):
    """A wrapped box copy with an eligible transpose: one kernel launch,
    bit-exact against the same copy on the CPU."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((12, 4, 5, 12)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((12, 5, 4, 12)).astype(np.float32))
    kw = dict(from0=(9, 0, 0, 10), size0=(8, 4, 5, 8), from1=(10, 0, 0, 9),
              copy_add="add")
    want = local_copy(-2.5, x, "xyzt", y, "tzyx", **kw)
    before = P.permute_4d.launches
    got = local_copy(-2.5, x.to(cuda_device), "xyzt", y.to(cuda_device), "tzyx", **kw)
    assert P.permute_4d.launches == before + 1
    assert torch.equal(got.cpu(), want)
