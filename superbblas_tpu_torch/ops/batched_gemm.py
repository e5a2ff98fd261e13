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
``batched_gemm_route`` decides: K3 (``sbt_batched_gemm_small``) for I, J
<= 64, and E1 (``sbt_batched_gemm_rowpack``) for every other shape.
``batched_gemm_rowpack`` launches E1 for any shape.  Both are one
templated kernel with register tiles and a ``cp.async`` ring, at the
tiles of ``CONFIGS`` (read from the kernel's source): K3's blocks walk
whole sites (``small_tile``), E1's stream chunks of J (``rowpack_tile``).  Both take f32 and f64, b and x of
one dtype, and sum each output in that dtype with fused multiply-adds in
a fixed order (J split among a block's warps where V is small, the
partial sums added in a fixed order): the same bits from run to run.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import Dict, Tuple

import torch

from .. import cplx
from . import _cuda

__all__ = ["batched_small_gemm", "batched_gemm_rowpack", "batched_small_gemm_reference",
           "batched_gemm_route", "small_tile", "rowpack_tile", "CONFIGS"]

#: the dtypes both kernels take
DTYPES = (torch.float32, torch.float64)
#: largest I and J that K3 takes (the TPU kernel's padded limit)
SMALL_MAX = 64
#: blocks a launch keeps before its tile splits J among the warps of a
#: block (and, for K3, before a block walks several sites): two for each
#: of the H100's 132 SMs.  A block's loads of b and x are rounds of
#: global-memory latency, so a few blocks leave the card waiting (E1 at
#: the V-cycle's (256, 4, 324, 8): 8 blocks of 32 sites took 0.19 ms)
MIN_BLOCKS = 264
#: blocks a launch keeps a walk of several sites a block (K3) above: 16
#: an SM, so that the waves of blocks stay many
WALK_BLOCKS = 16 * 132
#: most sites a K3 block walks
MAX_WALK = 2


def _read_tiles() -> Dict[int, Tuple[int, ...]]:
    """The kernel's tiles, from their only copy, the ``SBT_GEMM_TILES``
    table of ``csrc/batched_gemm.cu``: {number: (IT rows x NT columns of
    one site's y a block, RR x CC outputs a thread, J in chunks of JC, KS
    groups of warps splitting each step's KS * JC values of J, MINB blocks
    an SM asked of the register allocation)}; a block has (IT/RR) * (NT/CC)
    * KS threads.  The source's static_asserts hold each to the card's
    shared memory and thread limits."""
    src = (Path(__file__).resolve().parent.parent / "csrc" / "batched_gemm.cu").read_text()
    table = re.search(r"#define SBT_GEMM_TILES\(X\)(.*?)\n\n", src, re.S).group(1)
    rows = [tuple(int(v) for v in row.split(","))
            for row in re.findall(r"X\(([\d, ]+)\)", table)]
    return {row[0]: row[1:] for row in rows}


#: 0 wide (K3's main shape), 1 square (E1's main shape), 2 square with J
#: split 4 ways (few blocks), 3 narrow (I <= 4, N <= 8) and 4 tall (I <=
#: 16, N <= 8), J split 8 and 4 ways
CONFIGS = _read_tiles()


def batched_gemm_route(I: int, J: int, dtype) -> str:
    """Which kernel a CUDA call takes: "small" (K3) for I, J <= 64,
    "rowpack" (E1) otherwise.  Raises ValueError for a dtype other than
    f32 and f64, or an empty block.  The TPU kernel's eligibility
    (``batched_gemm_eligible``: f32, 8-aligned padding within a 128-tile)
    is not the card's."""
    if dtype not in DTYPES:
        raise ValueError(f"batched_small_gemm: dtype {dtype}; the kernels take "
                         "float32 and float64")
    if I < 1 or J < 1:
        raise ValueError(f"batched_small_gemm: empty block {I}x{J}")
    return "small" if I <= SMALL_MAX and J <= SMALL_MAX else "rowpack"


def _blocks(cfg: int, V: int, I: int, N: int) -> int:
    """Blocks of tile ``cfg`` with one site each."""
    IT, NT = CONFIGS[cfg][:2]
    return V * -(-I // IT) * -(-N // NT)


@functools.lru_cache(maxsize=None)
def _tile(V: int, I: int, J: int, N: int, walk: bool) -> Tuple[int, int]:
    """(tile, sites a block): narrow and tall tiles for a few rows and
    columns (their blocks always split J); otherwise wide (N > 32) or
    square tiles, split where one site a block gives fewer than MIN_BLOCKS
    blocks.  With ``walk`` (K3), a block whose J fits one step walks up to
    MAX_WALK sites while WALK_BLOCKS blocks remain."""
    if I <= 4 and N <= 8:
        cfg = 3
    elif I <= 16 and N <= 8:
        cfg = 4
    else:
        cfg = 0 if N > 32 else 1
        if _blocks(cfg, V, I, N) < MIN_BLOCKS:
            cfg = 2
    JC, KS = CONFIGS[cfg][4:6]
    sites = 1
    if walk and J <= JC * KS:
        sites = max(1, min(MAX_WALK, _blocks(cfg, V, I, N) // WALK_BLOCKS))
    return cfg, sites


def small_tile(V: int, I: int, J: int, N: int) -> Tuple[int, int]:
    """(tile, sites a block) of K3, cached by shape: the ring of a block
    runs over whole sites where J fits one step."""
    return _tile(V, I, J, N, True)


def rowpack_tile(V: int, I: int, J: int, N: int) -> Tuple[int, int]:
    """(tile, sites a block) of E1, cached by shape: one site a block, its
    ring over chunks of J."""
    return _tile(V, I, J, N, False)


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


def _launch(entry: str, b: torch.Tensor, x: torch.Tensor, cfg: int,
            sites: int) -> torch.Tensor:
    """One launch of the C entry ``entry`` at tile ``cfg``, ``sites`` a
    block, on b's device and its current stream; the device is switched
    only when it is not the current one."""
    if not (b.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{entry}: the kernel needs contiguous b and x")
    V, I, J = b.shape
    N = x.shape[2]
    y = b.new_empty((V, I, N))
    args = (int(b.dtype == torch.float64), V, I, J, N, cfg, sites, b.data_ptr(),
            x.data_ptr(), y.data_ptr())
    fn = getattr(_cuda.library(), entry)
    dev = b.device.index
    if dev == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return y


def _rowpack(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """E1 on checked CUDA operands: one launch, counted."""
    if _empty(b, x):
        return b.new_empty((b.shape[0], b.shape[1], x.shape[2]))
    V, I, J = b.shape
    y = _launch("sbt_batched_gemm_rowpack", b, x, *rowpack_tile(V, I, J, x.shape[2]))
    batched_gemm_rowpack.launches += 1
    return y


def batched_gemm_rowpack(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[v] = b[v] @ x[v] through E1 for any shape.  CPU tensors run the
    plain version; CUDA tensors run the kernel
    (``batched_gemm_rowpack.launches`` counts its launches) or raise."""
    _check(b, x, "batched_gemm_rowpack")
    if _on_cpu(b, "batched_gemm_rowpack"):
        return batched_small_gemm_reference(b, x)
    return _rowpack(b, x)


def batched_small_gemm(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[v] = b[v] @ x[v] for a batch of small matrices.

    ``b``: [V, I, J]; ``x``: [V, J, N]; returns [V, I, N] in their dtype
    (f32 or f64, one for both).  CPU tensors run the plain version.  CUDA
    tensors run K3 for I, J <= 64 (``batched_small_gemm.launches`` counts
    its launches) and E1 otherwise (counted as
    :func:`batched_gemm_rowpack`'s), or raise."""
    route = _check(b, x, "batched_small_gemm")
    if _on_cpu(b, "batched_small_gemm"):
        return batched_small_gemm_reference(b, x)
    if route == "rowpack":
        return _rowpack(b, x)
    if _empty(b, x):
        return b.new_empty((b.shape[0], b.shape[1], x.shape[2]))
    V, I, J = b.shape
    y = _launch("sbt_batched_gemm_small", b, x, *small_tile(V, I, J, x.shape[2]))
    batched_small_gemm.launches += 1
    return y


batched_small_gemm.launches = 0
batched_gemm_rowpack.launches = 0
