"""4-D tiled transpose, the label-permute fast path (counterpart of
``superbblas_tpu/ops/permute_pallas.py``).

``maybe_permute`` is what ``ops/copy.py``'s ``_permute_to`` calls: a
CUDA tensor with an eligible permutation goes to the hand-written kernel
``csrc/permute.cu`` through ``permute_4d``; every other case, CPU tensors
included, is ``x.permute(perm).contiguous()``, where the JAX package falls
to ``jnp.transpose``.  The choice is made from shape, permutation, dtype
and device alone.  ``permute_4d`` then takes one of two routes of the
kernel (``permute_route``): 16-byte words through a ring of shared-memory
tiles where the view's strides and pointers allow them, else 4-byte
words.

``permute_4d_tiled`` is the tile sweep E3 (counterpart of the probe
``experiments/permute_pallas.py``): the same transpose through one of the
card's design points ``TILES`` of ``csrc/permute.cu``, on the views the
16-byte route takes (``sweep_takes``).  Nothing dispatches it.

Under tracing (``torch.export``, ``torch.compile``) ``permute_4d`` on a
CUDA tensor is the custom op ``torch.ops.sbt.permute_4d``, whose
shape-only fake implementation lets a traced program hold the op and whose
real implementation is the eager call, so that a loaded exported program
launches K2.  Eager calls never go through the op.
"""

from __future__ import annotations

import collections
from typing import List, Sequence, Tuple

import torch

from . import _cuda
from ._guard import refuse_dtensor

__all__ = ["permute_eligible", "permute_route", "permute_4d", "permute_4d_reference",
           "maybe_permute", "permute_4d_tiled", "sweep_takes", "sweep_items", "TILES"]

#: permutations the kernel takes -> whether it swaps the middle axes
SUPPORTED = {(3, 1, 2, 0): False, (3, 2, 1, 0): True}
#: the tile sweep's design points (form, EX, ET, stages, threads): an (X, T)
#: tile of EX rows x ET words a ring stage, the ring's stages, threads a
#: block; form "ring" is the 16-byte ring kernel of permute_4d's 16-byte
#: route (K2_POINT is its own point), "tma" the TMA kernel (rows of 32
#: words, one producer warp and 4 consumer warps, 8 stages)
TILES = (("ring", 64, 128, 3, 256), ("ring", 64, 256, 3, 256), ("ring", 32, 256, 4, 256),
         ("ring", 64, 128, 4, 256), ("ring", 32, 128, 4, 128), ("ring", 128, 128, 2, 512),
         ("ring", 64, 64, 4, 256), ("tma", 64, 32, 8, 160), ("tma", 128, 32, 8, 160))
#: permute_4d's 16-byte route's design point
K2_POINT = ("ring", 64, 128, 3, 256)
#: the C entry's code of each form
FORMS = {"ring": 0, "tma": 1}


def permute_eligible(shape: Tuple[int, ...], perm: Tuple[int, ...], dtype) -> bool:
    """Whether the kernel takes this transpose: 4-D, perm (3,1,2,0) or
    (3,2,1,0), a 4-byte dtype, no empty axis, X > 1 and T > 1.  The TPU's
    block-size and VMEM rules (``_pick_block``) are not the card's."""
    if len(shape) != 4 or tuple(perm) not in SUPPORTED or dtype.itemsize != 4:
        return False
    return min(shape) >= 1 and shape[0] > 1 and shape[3] > 1


def permute_route(shape: Tuple[int, ...], strides: Tuple[int, ...], in_ptr: int,
                  out_ptr: int = 0) -> str:
    """The route of the kernel for an eligible input of ``shape`` [X, Y, Z,
    T] and ``strides`` (in words) at data pointer ``in_ptr``, into a
    contiguous output at ``out_ptr``: "vec16" (16-byte words) where T's
    stride is 1, X, T and the other strides are multiples of 4 words (the
    strides of axes of extent 1 aside), both pointers are 16-byte aligned
    and its tiles number fewer than 2^31 - 1 (counted at 64 x 64, at most
    as many as the kernel's), else "word" (4-byte words).  The keys of
    ``permute_4d.by_route``."""
    X, Y, Z, T = shape
    vec = _vec_view(shape, strides, in_ptr, out_ptr) \
        and Y * Z * -(-X // 64) * -(-T // 64) < 2 ** 31 - 1
    return "vec16" if vec else "word"


def permute_4d_reference(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version: the transposed copy, contiguous."""
    return x.permute(tuple(perm)).contiguous()


def _launch(x: torch.Tensor, perm: Tuple[int, ...]) -> Tuple[torch.Tensor, str]:
    out = torch.empty(tuple(x.shape[p] for p in perm), dtype=x.dtype, device=x.device)
    route = permute_route(tuple(x.shape), x.stride(), x.data_ptr(), out.data_ptr())
    _cuda.launch("sbt_permute_4d_vec" if route == "vec16" else "sbt_permute_4d", x.device,
                 int(SUPPORTED[perm]), *x.shape, *x.stride(), x.data_ptr(), out.data_ptr())
    return out, route


def permute_4d(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """``x.permute(perm)`` as a new contiguous tensor.

    A CPU tensor runs the plain version.  A CUDA tensor runs the kernel
    (``permute_4d.launches`` counts its launches, ``.by_route`` them by
    ``permute_route``'s name), reading ``x`` through its strides, or raises
    when the kernel does not take the case."""
    refuse_dtensor("permute_4d", "parallel.copy (or local_permute on the local shard)", x)
    perm = tuple(int(p) for p in perm)
    if not _cuda.on_card("permute_4d", x):
        return permute_4d_reference(x, perm)
    if not permute_eligible(tuple(x.shape), perm, x.dtype):
        raise ValueError(
            f"permute_4d: shape {tuple(x.shape)} {x.dtype} perm {perm}: the kernel "
            f"takes 4-D perms {tuple(SUPPORTED)} of 4-byte data with X, T > 1 "
            "(maybe_permute sends other cases to x.permute(perm).contiguous())")
    if torch.compiler.is_compiling():
        return torch.ops.sbt.permute_4d(x, list(perm))
    out, route = _launch(x, perm)
    permute_4d.launches += 1
    permute_4d.by_route[route] += 1
    return out


permute_4d.launches = 0
permute_4d.by_route = collections.Counter()


@torch.library.custom_op("sbt::permute_4d", mutates_args=())
def _permute_op(x: torch.Tensor, perm: List[int]) -> torch.Tensor:
    """:func:`permute_4d` as an op of a traced program."""
    return permute_4d(x, perm)


@_permute_op.register_fake
def _(x, perm):
    return x.new_empty(tuple(x.shape[p] for p in perm))


def maybe_permute(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """The transposed copy: the kernel for an eligible CUDA tensor, else
    ``x.permute(perm).contiguous()``."""
    refuse_dtensor("maybe_permute", "parallel.copy (or local_permute on the local shard)", x)
    perm = tuple(int(p) for p in perm)
    if x.device.type == "cuda" and permute_eligible(tuple(x.shape), perm, x.dtype):
        return permute_4d(x, perm)
    return x.permute(perm).contiguous()


def _vec_view(shape: Tuple[int, ...], strides: Tuple[int, ...], in_ptr: int,
              out_ptr: int) -> bool:
    X, Y, Z, T = shape
    sx, sy, sz, st = strides
    return (st == 1 or T == 1) and X % 4 == 0 and T % 4 == 0 \
        and all(s % 4 == 0 for n, s in ((X, sx), (Y, sy), (Z, sz)) if n > 1) \
        and in_ptr % 16 == 0 and out_ptr % 16 == 0


def sweep_takes(shape: Tuple[int, ...], strides: Tuple[int, ...], in_ptr: int,
                out_ptr: int = 0) -> bool:
    """Whether the tile sweep's 16-byte forms take an input of ``shape``
    [X, Y, Z, T] and ``strides`` (words) at ``in_ptr`` into a contiguous
    output at ``out_ptr``: T's stride 1, X, T and the other strides
    multiples of 4 words (axes of extent 1 aside), both pointers 16-byte
    aligned; the TMA point's tensor map has the same rules."""
    return _vec_view(shape, strides, in_ptr, out_ptr)


def sweep_items(shape: Tuple[int, ...], point: Tuple) -> Tuple[int, int, int]:
    """(items, X tiles, T tiles) of a design point on [X, Y, Z, T]: an item
    is one (y, z) plane's EX x ET tile, planes slowest, then the X tile,
    then the T tile; a persistent grid of blocks walks them, block b the
    items b, b + grid, ..."""
    X, Y, Z, T = shape
    _, EX, ET, _, _ = point
    ntx, ntt = -(-X // EX), -(-T // ET)
    return Y * Z * ntx * ntt, ntx, ntt


def permute_4d_tiled(x: torch.Tensor, perm: Sequence[int], tile: Tuple) -> torch.Tensor:
    """``x.permute(perm)`` as a new contiguous tensor, through the tile
    sweep's kernel at the design point ``tile`` (one of TILES).  A CPU
    tensor runs the plain version.  A CUDA tensor runs the kernel
    (``permute_4d_tiled.launches`` counts its launches) or raises
    ValueError where it does not take the case (``sweep_takes``)."""
    refuse_dtensor("permute_4d_tiled", "parallel.copy (or local_permute on the local shard)",
                   x)
    perm, tile = tuple(int(p) for p in perm), tuple(tile)
    if tile not in TILES:
        raise ValueError(f"permute_4d_tiled: design point {tile} is not one of {TILES}")
    if torch.compiler.is_compiling():
        return torch.ops.sbt.permute_4d_tiled(x, list(perm), tile[0], list(tile[1:]))
    if not _cuda.on_card("permute_4d_tiled", x):
        return permute_4d_reference(x, perm)
    if not permute_eligible(tuple(x.shape), perm, x.dtype):
        raise ValueError(
            f"permute_4d_tiled: shape {tuple(x.shape)} {x.dtype} perm {perm}: the kernel "
            f"takes 4-D perms {tuple(SUPPORTED)} of 4-byte data with X, T > 1")
    out = torch.empty(tuple(x.shape[p] for p in perm), dtype=x.dtype, device=x.device)
    if not sweep_takes(tuple(x.shape), x.stride(), x.data_ptr(), out.data_ptr()):
        raise ValueError(
            f"permute_4d_tiled: view {tuple(x.shape)} strides {x.stride()}: the sweep's "
            "16-byte forms take T's stride 1, X, T and the other strides in whole 16 bytes "
            "and 16-byte aligned pointers (permute_4d's word route takes the rest)")
    _cuda.launch("sbt_permute_4d_tiled", x.device, FORMS[tile[0]], *tile[1:],
                 int(SUPPORTED[perm]), *x.shape, *x.stride(), x.data_ptr(), out.data_ptr())
    permute_4d_tiled.launches += 1
    return out


permute_4d_tiled.launches = 0


@torch.library.custom_op("sbt::permute_4d_tiled", mutates_args=())
def _tiled_op(x: torch.Tensor, perm: List[int], form: str, point: List[int]) -> torch.Tensor:
    """:func:`permute_4d_tiled` as an op of a traced program (the design
    point split into its form and its numbers)."""
    return permute_4d_tiled(x, perm, (form,) + tuple(point))


@_tiled_op.register_fake
def _(x, perm, form, point):
    return x.new_empty(tuple(x.shape[p] for p in perm))
