"""Batched small GEMM, y[v] = b[v] @ x[v] over many small blocks
(counterpart of ``superbblas_tpu/ops/batched_gemm_pallas.py`` and of the
row-packed probe ``experiments/bgemm_rowpack_probe.py``; the analog of the
reference's ``xgemm_batch_strided``, blas.h:662-812).

    b  [V, I, J],  x  [V, J, N]  ->  y  [V, I, N]

It is the coarse-operator apply of multigrid: ``bsr.py``'s no-kron
``_apply_stencil`` stacks the ndir neighbour operands into J = ndir*BD and
calls it three times per apply (the split-complex Gauss products).

``batched_small_gemm`` sends CPU tensors to the plain PyTorch version
``batched_small_gemm_reference`` and CUDA tensors to one of two
hand-written kernels in ``csrc/batched_gemm.cu``, as
``batched_gemm_route`` decides: K3 (``sbt_batched_gemm_small``, the whole
of each b[v] in shared memory) for I, J <= 64, and E1
(``sbt_batched_gemm_rowpack``, up to 128 rows of b and x streamed through
shared memory in chunks of J) for every other shape.
``batched_gemm_rowpack`` launches E1 for any shape.  Both take f32 and
f64, b and x of one dtype, and sum each output over j in ascending order
with fused multiply-adds in that dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import cplx

__all__ = ["batched_small_gemm", "batched_gemm_rowpack", "batched_small_gemm_reference",
           "batched_gemm_route", "small_tile", "rowpack_tile"]

#: the dtypes both kernels take
DTYPES = (torch.float32, torch.float64)
#: largest I and J that K3 takes (the TPU kernel's padded limit)
SMALL_MAX = 64
#: threads of a block
THREADS = 256
#: shared memory one block may use on the H100 (227 KB), and the share the
#: tile choices aim for, so that two blocks fit an SM
SMEM_BYTES = 232448
SMEM_AIM = 98304
#: blocks a launch keeps before it packs several sites into one: two for
#: each of the H100's 132 SMs.  A block's loads of b and x are serial
#: rounds of global-memory latency, so a few blocks of many sites leave
#: the card waiting (E1 at the V-cycle's (256, 4, 324, 8): 8 blocks of 32
#: sites took 0.19 ms)
MIN_BLOCKS = 264
_GRID_YZ = 65535


def batched_gemm_route(I: int, J: int, dtype) -> str:
    """Which kernel a CUDA call takes: "small" (K3) for I, J <= 64,
    "rowpack" (E1) otherwise.  Raises ValueError for a dtype other than
    f32 and f64, or an empty block.  E1 takes these shapes too, but K3
    ran faster at each I, J <= 64 shape timed beside it (``chip_smoke.py``'s
    ``time_gemms``; ``PERF.md`` §6).  The TPU kernel's eligibility
    (``batched_gemm_eligible``: f32, 8-aligned padding within a 128-tile)
    is not the card's."""
    if dtype not in DTYPES:
        raise ValueError(f"batched_small_gemm: dtype {dtype}; the kernels take "
                         "float32 and float64")
    if I < 1 or J < 1:
        raise ValueError(f"batched_small_gemm: empty block {I}x{J}")
    return "small" if I <= SMALL_MAX and J <= SMALL_MAX else "rowpack"


def _rows_a_thread(rows: int) -> int:
    """RR, the rows of one site a thread keeps in registers: 4, 8 or 16."""
    return 16 if rows > 8 else 8 if rows > 4 else 4


def _spread(blocks_a_site: int, V: int) -> int:
    """The most sites a block may take and still leave MIN_BLOCKS blocks
    (or one a site, when there are fewer)."""
    return max(1, V * blocks_a_site // MIN_BLOCKS)


def small_tile(V: int, I: int, J: int, N: int,
               itemsize: int) -> Tuple[int, int, int, int]:
    """(S, NT, RR, shared bytes) of K3: a block takes S sites and NT <= 128
    columns; b[v] (rows padded to an odd length, so rows fall in different
    banks) and a [J, NT] tile of x[v] of each site sit in shared memory; a
    thread computes RR rows of one column, so a block has S * ceil(I/RR)
    * NT <= 256 such items; S stays small enough for MIN_BLOCKS blocks."""
    RR = _rows_a_thread(I)
    G = -(-I // RR)
    NT = min(N, 128)
    while G * NT > THREADS:
        NT //= 2
    per_site = (I * (J | 1) + J * NT) * itemsize
    S = max(1, min(V, THREADS // (G * NT), SMEM_AIM // per_site,
                   _spread(-(-N // NT), V)))
    return S, NT, RR, S * per_site


def rowpack_tile(V: int, I: int, J: int, N: int,
                 itemsize: int) -> Tuple[int, int, int, int, int, int]:
    """(S, IT, NT, JC, RR, shared bytes) of E1: a block takes IT <= 32 rows
    of each of S sites (S*IT <= 128 rows, 4 sites x 32 rows at the probe's
    shape) and NT <= 32 columns, and streams J through shared memory in
    chunks of JC <= 32; a thread keeps RR rows of one column in registers,
    S * ceil(IT/RR) * NT <= 256 items a block; S stays small enough for
    MIN_BLOCKS blocks."""
    IT, NT, JC = min(I, 32), min(N, 32), min(J, 32)
    RR = _rows_a_thread(IT)
    per_site = (IT * (JC | 1) + JC * NT) * itemsize
    S = max(1, min(V, THREADS // (-(-IT // RR) * NT), 128 // IT, SMEM_AIM // per_site,
                   _spread(-(-I // IT) * -(-N // NT), V)))
    return S, IT, NT, JC, RR, S * per_site


def batched_small_gemm_reference(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``einsum("vij,vjn->vin")`` in the operands'
    type (TF32 off on the card)."""
    with cplx._full_f32():
        return torch.einsum("vij,vjn->vin", b, x)


def _check(b: torch.Tensor, x: torch.Tensor, name: str) -> str:
    """Raise unless (b, x) is a batched product both kernels take, on any
    device; returns the route."""
    if b.ndim != 3 or x.ndim != 3 or b.shape[0] != x.shape[0] or b.shape[2] != x.shape[1]:
        raise ValueError(f"{name}: b {tuple(b.shape)} and x {tuple(x.shape)} are not "
                         "[V, I, J] and [V, J, N]")
    if b.dtype != x.dtype:
        raise ValueError(f"{name}: b is {b.dtype} and x {x.dtype}; the kernels take "
                         "one dtype")
    if b.device != x.device:
        raise ValueError(f"{name}: b on {b.device} and x on {x.device}")
    return batched_gemm_route(b.shape[1], b.shape[2], b.dtype)


def _on_cpu(b: torch.Tensor, name: str) -> bool:
    if b.device.type == "cpu":
        return True
    if b.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {b.device}")
    return False


def _empty(b: torch.Tensor, x: torch.Tensor) -> bool:
    """No output to compute (V or N is 0): the wrappers launch nothing."""
    return b.shape[0] == 0 or x.shape[2] == 0


def _launch(entry: str, b: torch.Tensor, x: torch.Tensor, *tile) -> torch.Tensor:
    from . import _cuda

    if not (b.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{entry}: the kernel needs contiguous b and x")
    V, I, J = b.shape
    N = x.shape[2]
    y = torch.empty((V, I, N), dtype=b.dtype, device=b.device)
    with torch.cuda.device(b.device):
        err = getattr(_cuda.library(), entry)(
            int(b.dtype == torch.float64), V, I, J, N, *tile,
            b.data_ptr(), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return y


def batched_gemm_rowpack(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[v] = b[v] @ x[v] through E1 for any shape.  CPU tensors run the
    plain version; CUDA tensors run the kernel
    (``batched_gemm_rowpack.launches`` counts its launches) or raise."""
    _check(b, x, "batched_gemm_rowpack")
    if _on_cpu(b, "batched_gemm_rowpack"):
        return batched_small_gemm_reference(b, x)
    if _empty(b, x):
        return b.new_empty((b.shape[0], b.shape[1], x.shape[2]))
    V, I, J = b.shape
    S, IT, NT, JC, RR, smem = rowpack_tile(V, I, J, x.shape[2], b.element_size())
    if -(-I // IT) > _GRID_YZ or -(-x.shape[2] // NT) > _GRID_YZ or smem > SMEM_BYTES:
        raise ValueError(f"batched_gemm_rowpack: {tuple(b.shape)} x {tuple(x.shape)} "
                         "is outside the kernel's grid")
    y = _launch("sbt_batched_gemm_rowpack", b, x, S, IT, NT, JC, RR)
    batched_gemm_rowpack.launches += 1
    return y


def batched_small_gemm(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[v] = b[v] @ x[v] for a batch of small matrices.

    ``b``: [V, I, J]; ``x``: [V, J, N]; returns [V, I, N] in their dtype
    (f32 or f64, one for both).  CPU tensors run the plain version.  CUDA
    tensors run K3 for I, J <= 64 (``batched_small_gemm.launches`` counts
    its launches) and E1 otherwise (through :func:`batched_gemm_rowpack`),
    or raise."""
    route = _check(b, x, "batched_small_gemm")
    if _on_cpu(b, "batched_small_gemm"):
        return batched_small_gemm_reference(b, x)
    if route == "rowpack":
        return batched_gemm_rowpack(b, x)
    if _empty(b, x):
        return b.new_empty((b.shape[0], b.shape[1], x.shape[2]))
    V, I, J = b.shape
    S, NT, RR, smem = small_tile(V, I, J, x.shape[2], b.element_size())
    if -(-x.shape[2] // NT) > _GRID_YZ or smem > SMEM_BYTES:
        raise ValueError(f"batched_small_gemm: {tuple(b.shape)} x {tuple(x.shape)} "
                         "is outside the kernel's grid")
    y = _launch("sbt_batched_gemm_small", b, x, S, NT, RR)
    batched_small_gemm.launches += 1
    return y


batched_small_gemm.launches = 0
batched_gemm_rowpack.launches = 0
