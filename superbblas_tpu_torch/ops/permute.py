"""4-D tiled transpose, the label-permute fast path (counterpart of
``superbblas_tpu/ops/permute_pallas.py``).

``maybe_permute`` is what ``ops/copy.py``'s ``_permute_to`` calls: a
CUDA tensor with an eligible permutation goes to the hand-written kernel
``csrc/permute.cu`` through ``permute_4d``; every other case, CPU tensors
included, is ``x.permute(perm).contiguous()``, where the JAX package falls
to ``jnp.transpose``.  The choice is made from shape, permutation, dtype
and device alone.

``permute_4d_tiled`` is the tile sweep E3 (counterpart of the probe
``experiments/permute_pallas.py``): the same transpose through the
instantiation of ``csrc/permute.cu`` at one tile of ``TILES``, on the grid
``tiled_grid`` gives it.  Nothing dispatches it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["permute_eligible", "permute_4d", "permute_4d_reference", "maybe_permute",
           "permute_4d_tiled", "tiled_grid", "TILES"]

#: permutations the kernel takes -> whether it swaps the middle axes
SUPPORTED = {(3, 1, 2, 0): False, (3, 2, 1, 0): True}
#: tiles (edge E, thread rows R, (y, z) planes P) of the tile sweep: an E x E
#: tile of the (X, T) plane, E x R threads, P planes a block; (32, 8, 1) is
#: permute_4d's own
TILES = ((32, 8, 1), (32, 8, 2), (32, 8, 4), (32, 16, 1), (64, 8, 1), (64, 16, 2))
#: most blocks along the grid's y and z axes
MAX_GRID_YZ = 65535


def permute_eligible(shape: Tuple[int, ...], perm: Tuple[int, ...], dtype) -> bool:
    """Whether the kernel takes this transpose: 4-D, perm (3,1,2,0) or
    (3,2,1,0), a 4-byte dtype, no empty axis, X > 1 and T > 1.  The TPU's
    block-size and VMEM rules (``_pick_block``) are not the card's."""
    if len(shape) != 4 or tuple(perm) not in SUPPORTED or dtype.itemsize != 4:
        return False
    return min(shape) >= 1 and shape[0] > 1 and shape[3] > 1


def permute_4d_reference(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version: the transposed copy, contiguous."""
    return x.permute(tuple(perm)).contiguous()


def _launch(x: torch.Tensor, perm: Tuple[int, ...]) -> torch.Tensor:
    from . import _cuda

    out = torch.empty(tuple(x.shape[p] for p in perm), dtype=x.dtype, device=x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.sbt_permute_4d(int(SUPPORTED[perm]), *x.shape, *x.stride(),
                                 x.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"permute_4d kernel launch failed: cudaError {err}")
    return out


def permute_4d(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """``x.permute(perm)`` as a new contiguous tensor.

    A CPU tensor runs the plain version.  A CUDA tensor runs the kernel
    (``permute_4d.launches`` counts its launches), reading ``x`` through
    its strides, or raises when the kernel does not take the case."""
    perm = tuple(int(p) for p in perm)
    if x.device.type == "cpu":
        return permute_4d_reference(x, perm)
    if x.device.type != "cuda":
        raise ValueError(f"permute_4d: no kernel for device {x.device}")
    if not permute_eligible(tuple(x.shape), perm, x.dtype):
        raise ValueError(
            f"permute_4d: shape {tuple(x.shape)} {x.dtype} perm {perm}: the kernel "
            f"takes 4-D perms {tuple(SUPPORTED)} of 4-byte data with X, T > 1 "
            "(maybe_permute sends other cases to x.permute(perm).contiguous())")
    out = _launch(x, perm)
    permute_4d.launches += 1
    return out


permute_4d.launches = 0


def maybe_permute(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """The transposed copy: the kernel for an eligible CUDA tensor, else
    ``x.permute(perm).contiguous()``."""
    perm = tuple(int(p) for p in perm)
    if x.device.type == "cuda" and permute_eligible(tuple(x.shape), perm, x.dtype):
        return permute_4d(x, perm)
    return x.permute(perm).contiguous()


def tiled_grid(shape: Tuple[int, ...], tile: Tuple[int, int, int],
               max_yz: int = MAX_GRID_YZ) -> Tuple[int, int, int]:
    """The grid of the tile sweep on [X, Y, Z, T]: T tiles, X tiles and
    plane groups, the last two capped at ``max_yz`` (the kernel's loops
    stride over the rest)."""
    X, Y, Z, T = shape
    E, _, P = tile
    return (-(-T // E), min(-(-X // E), max_yz), min(-(-(Y * Z) // P), max_yz))


def permute_4d_tiled(x: torch.Tensor, perm: Sequence[int],
                     tile: Tuple[int, int, int]) -> torch.Tensor:
    """``x.permute(perm)`` as a new contiguous tensor, through the tile
    sweep's kernel at ``tile`` (one of TILES).  A CPU tensor runs the plain
    version.  A CUDA tensor runs the kernel (``permute_4d_tiled.launches``
    counts its launches) or raises where it does not take the case."""
    perm, tile = tuple(int(p) for p in perm), tuple(int(v) for v in tile)
    if tile not in TILES:
        raise ValueError(f"permute_4d_tiled: tile {tile} is not one of {TILES}")
    if x.device.type == "cpu":
        return permute_4d_reference(x, perm)
    if x.device.type != "cuda":
        raise ValueError(f"permute_4d_tiled: no kernel for device {x.device}")
    if not permute_eligible(tuple(x.shape), perm, x.dtype):
        raise ValueError(
            f"permute_4d_tiled: shape {tuple(x.shape)} {x.dtype} perm {perm}: the kernel "
            f"takes 4-D perms {tuple(SUPPORTED)} of 4-byte data with X, T > 1")
    from . import _cuda

    out = torch.empty(tuple(x.shape[p] for p in perm), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _cuda.library().sbt_permute_4d_tiled(
            *tile, int(SUPPORTED[perm]), *x.shape, *x.stride(),
            *tiled_grid(tuple(x.shape), tile), x.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"permute_4d_tiled kernel launch failed: cudaError {err}")
    permute_4d_tiled.launches += 1
    return out


permute_4d_tiled.launches = 0
