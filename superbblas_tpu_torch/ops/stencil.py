"""Nearest-neighbour block stencil in the structure-of-arrays layout
(counterpart of ``superbblas_tpu/ops/stencil_pallas.py``).

    x       [n, KD*BD, X, Y, Z, T]
    blocks  [ndir, BI*BD, X, Y, Z, T]
    kron    [ndir, KI, KD]           (None: KI = KD = 1, factor 1)
    y       [n, KI*BI, X, Y, Z, T]

``stencil_matvec_soa`` sends CPU tensors to the plain PyTorch version
``stencil_matvec_soa_reference`` and CUDA tensors to the hand-written
kernel ``csrc/stencil_soa.cu``: its templated route at ``KERNEL_SHAPES``,
its runtime-shape route (``stencil_matvec_soa_rt``) at every other shape
with KI*KD*BI*BD <= 256, the TPU kernel's rule; a case no route takes
raises.  ``stencil_matvec_soa_xin`` and ``stencil_matvec_soa_stream``
compute the same function with other schedules of the X neighbours
(``csrc/stencil_schedules.cu``, at ``SCHEDULE_SHAPES``); no caller
dispatches them.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cplx
from ..cplx import CArray

__all__ = ["stencil_matvec_soa", "stencil_matvec_soa_reference", "stencil_matvec_soa_rt",
           "stencil_matvec_soa_xin", "stencil_matvec_soa_stream",
           "soa_eligible", "aos_to_soa", "soa_to_aos"]

#: (KI, KD, BI, BD) shapes of K1's templated route: Wilson, staggered and
#: the clover term; every other shape takes the runtime-shape route
KERNEL_SHAPES = ((4, 4, 3, 3), (1, 1, 3, 3), (1, 1, 12, 12))
#: the shapes the X-inside and X-streaming schedules are instantiated at
SCHEDULE_SHAPES = ((4, 4, 3, 3), (1, 1, 3, 3))
#: most KI*KD*BI*BD a stencil takes (the TPU kernel's rule)
MAX_BLOCK = 256
#: (block storage dtype, field dtype) pairs K1 takes, in the order of the
#: C entries' pair code (csrc/stencil_soa.cuh kPair): summed in f32 (bf16
#: converted on load, rounded on store), f64/f64 summed in f64
KERNEL_DTYPES = ((torch.float32, torch.float32),
                 (torch.bfloat16, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.bfloat16),
                 (torch.float64, torch.float64))
#: the pairs the X-inside and X-streaming schedules take
SCHEDULE_DTYPES = KERNEL_DTYPES[:3]
#: most directions the kernel takes (csrc/stencil_soa.cuh kMaxDirs)
MAX_DIRS = 16
#: shared memory one block may use on the H100 (227 KB)
SMEM_BYTES = 232448

_TODO = "the schedules at more type pairs: ROADMAP.md, Queue 2 A"


def _axis_of(off) -> Tuple[int, int]:
    """(axis, sign) of a one-hot +-1 offset; (-1, 0) for the centre."""
    nz = [(ax, o) for ax, o in enumerate(off) if o != 0]
    if not nz:
        return -1, 0
    if len(nz) != 1 or abs(nz[0][1]) != 1:
        raise ValueError(f"stencil kernel requires one-hot +-1 offsets, got {off}")
    return nz[0]


def soa_eligible(offsets, dim_lat, bi: int = 1, bd: int = 1, ki: int = 1,
                 kd: int = 1) -> bool:
    """Whether the SoA layout holds this stencil: a 4-D lattice, at most
    MAX_DIRS one-hot +-1 offsets, KI*KD*BI*BD <= MAX_BLOCK.  The TPU's
    tiling rules (T % 128, Z % 8) are not the card's."""
    if len(dim_lat) != 4 or not 0 < len(offsets) <= MAX_DIRS \
            or ki * kd * bi * bd > MAX_BLOCK:
        return False
    try:
        for off in offsets:
            _axis_of(off)
    except ValueError:
        return False
    return all(int(v) > 0 for v in dim_lat)


def stencil_matvec_soa_reference(blocks: CArray, kron: Optional[CArray],
                                 x: CArray, offsets, bi: int, bd: int,
                                 packed_parity: Optional[int] = None) -> CArray:
    """Plain PyTorch version with the same SoA signature.  Arithmetic runs
    in the promoted dtype of the operands, at least f32 (bf16 operands are
    converted on load, as in the kernel); the output has x's dtype.
    ``packed_parity`` selects the checkerboard-packed X-shift semantics."""
    ndir = blocks.shape[0]
    cdt = torch.promote_types(torch.promote_types(blocks.dtype, x.dtype),
                              torch.float32)
    dev = x.device
    if kron is None:
        kron = CArray(torch.ones((ndir, 1, 1), dtype=cdt, device=dev),
                      torch.zeros((ndir, 1, 1), dtype=cdt, device=dev))
    cdt = torch.promote_types(cdt, kron.dtype)
    blocks, kron, xc = (c.to(cdt) for c in (blocks, kron, x))
    KI, KD = kron.shape[1], kron.shape[2]
    n = x.shape[0]
    lat = tuple(x.shape[2:])
    if packed_parity is not None:
        rest = lat[1:]
        coords = np.meshgrid(*[np.arange(d) for d in rest], indexing="ij")
        m = (packed_parity + sum(coords)) % 2 == 1
        img_x_odd = torch.from_numpy(m.reshape((1, 1, 1) + tuple(rest))).to(dev)

    def roll(a, off):
        for ax, o in enumerate(off):
            if o % (lat[ax] if packed_parity is None or ax != 0 else 10 ** 9) != 0:
                if packed_parity is not None and ax == 0:
                    sh = torch.roll(a, -o, dims=3)
                    a = torch.where(img_x_odd, sh, a) if o > 0 else \
                        torch.where(img_x_odd, a, sh)
                else:
                    a = torch.roll(a, -o, dims=3 + ax)
        return a

    y = None
    xs4 = cplx.cmap(lambda a: a.reshape((n, KD, bd) + lat), xc)
    for d in range(ndir):
        xd = cplx.cmap(lambda a: roll(a, offsets[d]), xs4)
        kr = CArray(kron.re[d], kron.im[d])
        z = cplx.cbilinear(lambda K, V: torch.einsum("ab,nbj...->naj...", K, V),
                           kr, xd)
        blk = cplx.cmap(lambda a: a[d].reshape((bi, bd) + lat), blocks)
        t = cplx.cbilinear(lambda B, V: torch.einsum("ij...,naj...->nai...", B, V),
                           blk, z)
        y = t if y is None else cplx.add(y, t)
    return cplx.cmap(lambda a: a.reshape((n, KI * bi) + lat).to(x.dtype), y)


def aos_to_soa(x: CArray, nlat: int) -> CArray:
    """[*lat, KD, BD, n] -> [n, KD*BD, *lat], contiguous (as the kernels
    take it)."""
    def t(a):
        nd = a.ndim
        a = a.permute((nd - 1, nd - 3, nd - 2) + tuple(range(nlat)))
        return a.reshape((a.shape[0], a.shape[1] * a.shape[2])
                         + tuple(a.shape[3:])).contiguous()
    return cplx.cmap(t, x)


def soa_to_aos(y: CArray, nlat: int, ki: int, bi: int) -> CArray:
    """[n, KI*BI, *lat] -> [*lat, KI, BI, n]."""
    def t(a):
        a = a.reshape((a.shape[0], ki, bi) + tuple(a.shape[2:]))
        return a.permute(tuple(range(3, 3 + nlat)) + (1, 2, 0))
    return cplx.cmap(t, y)


def check_block(KI: int, KD: int, bi: int, bd: int) -> None:
    """Raise ValueError above the MAX_BLOCK rule, on every device."""
    if min(KI, KD, bi, bd) < 1 or KI * KD * bi * bd > MAX_BLOCK:
        raise ValueError(f"(KI, KD, BI, BD) = {(KI, KD, bi, bd)}: the SoA stencil takes "
                         f"positive extents with KI*KD*BI*BD <= {MAX_BLOCK}")


def check_kernel_case(blocks: CArray, kron: Optional[CArray], x: CArray,
                      offsets, bi: int, bd: int,
                      packed_parity: Optional[int] = None,
                      shapes: Optional[Sequence[Tuple[int, int, int, int]]] = None
                      ) -> Tuple[int, int]:
    """Raise unless a CUDA stencil kernel takes these operands (device
    aside): K1 any shape within MAX_BLOCK and every pair of KERNEL_DTYPES,
    a schedule only its ``shapes`` and SCHEDULE_DTYPES; returns (KI,
    KD)."""
    if packed_parity not in (None, 0, 1):
        raise ValueError(f"packed_parity={packed_parity!r}: a checkerboard parity is "
                         "None, 0 or 1")
    ndir = blocks.shape[0]
    KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
    check_block(KI, KD, bi, bd)
    if shapes is not None and (KI, KD, bi, bd) not in shapes:
        raise NotImplementedError(
            f"(KI, KD, BI, BD) = {(KI, KD, bi, bd)} in the X-inside and X-streaming "
            f"stencil kernels, which take {tuple(shapes)}; stencil_matvec_soa takes "
            f"every shape (ROADMAP.md, Next slices: schedules at more shapes)")
    pairs = KERNEL_DTYPES if shapes is None else SCHEDULE_DTYPES
    if (blocks.dtype, x.dtype) not in pairs:
        if shapes is None:
            raise ValueError(f"storage/field dtypes {blocks.dtype}/{x.dtype}: the CUDA "
                             f"stencil kernel takes {KERNEL_DTYPES}")
        raise NotImplementedError(
            f"storage/field dtypes {blocks.dtype}/{x.dtype} in the X-inside and "
            f"X-streaming stencil kernels, which take {SCHEDULE_DTYPES} ({_TODO}); "
            "stencil_matvec_soa takes every pair of KERNEL_DTYPES")
    if not soa_eligible(offsets, tuple(blocks.shape[2:])) \
            or len(offsets) != ndir:
        raise ValueError(f"{len(offsets)} offsets {offsets} for {ndir} directions: "
                         f"need <= {MAX_DIRS} one-hot +-1 offsets on a 4-D lattice")
    lat = tuple(blocks.shape[2:])
    n = x.shape[0]
    for name, c, shape in (("blocks", blocks, (ndir, bi * bd) + lat),
                           ("x", x, (n, KD * bd) + lat),
                           ("kron", kron, (ndir, KI, KD))):
        if c is None:
            continue
        if c.re.dtype != c.im.dtype or tuple(c.re.shape) != shape \
                or tuple(c.im.shape) != shape:
            raise ValueError(f"{name}: parts {tuple(c.re.shape)}/{tuple(c.im.shape)} "
                             f"{c.re.dtype}/{c.im.dtype}, expected {shape}")
        if not (c.re.is_contiguous() and c.im.is_contiguous()):
            raise ValueError(f"{name}: the CUDA stencil kernel needs contiguous parts")
    if n < 1 or n > 8 * 65535 or any(v > 2 ** 31 - 1 for v in lat):
        raise ValueError(f"{n} columns on lattice {lat}: outside the kernel's grid")
    return KI, KD


def xin_tile(n: int, X: int, F: int, itemsize: int, nk: int) -> Tuple[int, int, int]:
    """(S, C, XG) of the X-inside kernel: a tile of S (y, z, t) sites x C
    columns whose X lines (X x F features x 2 parts of ``itemsize`` bytes)
    sit in shared memory beside ``nk`` kron entries, and XG thread groups
    over X, at most 256 threads.  Raises ValueError where no tile fits, as
    the TPU wrapper does where no (nc, Yc) fits its VMEM."""
    per_pair = X * F * 2 * itemsize
    room = SMEM_BYTES - 4 * ((2 * nk + 3) // 4 * 4)
    pairs = min(256, room // per_pair)
    if pairs < 1:
        raise ValueError(
            f"no tile of the X-inside stencil kernel fits in shared memory: one X "
            f"line of {X} sites x {F} features takes {per_pair} B, {room} B are free")
    C = max(1, min(n, 8, pairs // 32))
    S = pairs // C
    if S >= 32:
        S = S // 32 * 32
    return S, C, max(1, min(X, 256 // (S * C)))


def _launch(entry: str, blocks, kron, x, offsets, bi, bd, KI, KD, *extra) -> CArray:
    """Run C entry ``entry`` on the operands; returns y."""
    from . import _cuda

    dev = x.device
    for c in (blocks, kron):
        if c is not None and (c.re.device != dev or c.im.device != dev):
            raise ValueError(f"operands on {c.re.device}/{c.im.device} and {dev}")
    # the kron factors in the type the pair sums in
    kdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    if kron is not None:
        kron = cplx.cmap(lambda a: a.to(kdt).contiguous(), kron)
    n = x.shape[0]
    lat = tuple(x.shape[2:])
    y = CArray(torch.empty((n, KI * bi) + lat, dtype=x.dtype, device=dev),
               torch.empty((n, KI * bi) + lat, dtype=x.dtype, device=dev))
    flat = [int(v) for off in offsets for v in off]
    offs = (ctypes.c_int * len(flat))(*flat)
    with torch.cuda.device(dev):
        err = getattr(_cuda.library(), entry)(
            KI, KD, bi, bd, KERNEL_DTYPES.index((blocks.dtype, x.dtype)),
            blocks.re.data_ptr(), blocks.im.data_ptr(),
            None if kron is None else kron.re.data_ptr(),
            None if kron is None else kron.im.data_ptr(),
            x.re.data_ptr(), x.im.data_ptr(), y.re.data_ptr(), y.im.data_ptr(),
            n, *lat, len(offsets), offs, *extra,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return y


def _on_cpu(blocks: CArray, x: CArray, name: str) -> bool:
    """True for CPU operands (the plain version's case), False for CUDA
    ones; raises for any other device."""
    if x.re.device.type == "cpu" and blocks.re.device.type == "cpu":
        return True
    if x.re.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.re.device}")
    return False


def stencil_matvec_soa(blocks: CArray, kron: Optional[CArray], x: CArray,
                       offsets: Sequence[Tuple[int, ...]], bi: int, bd: int,
                       packed_parity: Optional[int] = None) -> CArray:
    """y[n, KI*BI, X, Y, Z, T] = SoA stencil matvec; with ``packed_parity``
    (0 or 1) the operands hold one checkerboard parity with X halved.

    CPU operands run the plain version.  CUDA operands run the kernel:
    its templated route at KERNEL_SHAPES (``stencil_matvec_soa.launches``
    counts those launches, ``.by_shape`` them by shape),
    :func:`stencil_matvec_soa_rt` at the other
    shapes; a case neither takes raises.  Above MAX_BLOCK it raises
    ValueError on every device."""
    KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
    check_block(KI, KD, bi, bd)
    if _on_cpu(blocks, x, "stencil_matvec_soa"):
        return stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd,
                                            packed_parity=packed_parity)
    if (KI, KD, bi, bd) not in KERNEL_SHAPES:
        return stencil_matvec_soa_rt(blocks, kron, x, offsets, bi, bd,
                                     packed_parity=packed_parity)
    check_kernel_case(blocks, kron, x, offsets, bi, bd, packed_parity)
    y = _launch("sbt_stencil_soa", blocks, kron, x, offsets, bi, bd, KI, KD,
                -1 if packed_parity is None else int(packed_parity))
    stencil_matvec_soa.launches += 1
    stencil_matvec_soa.by_shape[KI, KD, bi, bd] += 1
    return y


def stencil_matvec_soa_rt(blocks: CArray, kron: Optional[CArray], x: CArray,
                          offsets: Sequence[Tuple[int, ...]], bi: int, bd: int,
                          packed_parity: Optional[int] = None) -> CArray:
    """K1's runtime-shape route (same contract as
    :func:`stencil_matvec_soa`, any shape with KI*KD*BI*BD <= MAX_BLOCK, at
    most 65535 columns): ``stencil_matvec_soa`` sends the shapes outside
    KERNEL_SHAPES here.  At a templated shape it gives the templated
    route's bits.  CPU operands run the plain version; CUDA operands the
    kernel (``stencil_matvec_soa_rt.launches``) or raise."""
    if _on_cpu(blocks, x, "stencil_matvec_soa_rt"):
        KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
        check_block(KI, KD, bi, bd)
        return stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd,
                                            packed_parity=packed_parity)
    KI, KD = check_kernel_case(blocks, kron, x, offsets, bi, bd, packed_parity)
    if x.shape[0] > 65535:
        raise ValueError(f"{x.shape[0]} columns: the runtime-shape stencil kernel takes "
                         "at most 65535")
    y = _launch("sbt_stencil_soa_rt", blocks, kron, x, offsets, bi, bd, KI, KD,
                -1 if packed_parity is None else int(packed_parity))
    stencil_matvec_soa_rt.launches += 1
    stencil_matvec_soa_rt.by_shape[KI, KD, bi, bd] += 1
    return y


def stencil_matvec_soa_xin(blocks: CArray, kron: Optional[CArray], x: CArray,
                           offsets: Sequence[Tuple[int, ...]], bi: int,
                           bd: int) -> CArray:
    """X-inside schedule of :func:`stencil_matvec_soa` (same contract, no
    packed parity): each block holds its tile's whole X lines in shared
    memory.  Raises ValueError where no tile fits (``xin_tile``), on
    every device.  CPU operands run the plain version; CUDA operands the
    kernel (``stencil_matvec_soa_xin.launches``) or raise."""
    KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
    tile = xin_tile(x.shape[0], x.shape[2], KD * bd, x.re.element_size(),
                    blocks.shape[0] * KI * KD)
    if _on_cpu(blocks, x, "stencil_matvec_soa_xin"):
        return stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd)
    check_kernel_case(blocks, kron, x, offsets, bi, bd, shapes=SCHEDULE_SHAPES)
    y = _launch("sbt_stencil_soa_xin", blocks, kron, x, offsets, bi, bd, KI, KD, *tile)
    stencil_matvec_soa_xin.launches += 1
    return y


def stencil_matvec_soa_stream(blocks: CArray, kron: Optional[CArray], x: CArray,
                              offsets: Sequence[Tuple[int, ...]], bi: int,
                              bd: int) -> CArray:
    """X-streaming schedule of :func:`stencil_matvec_soa` (same contract,
    no packed parity): each block walks X with a ring of X planes of its
    tile in shared memory.  CPU operands run the plain version; CUDA
    operands the kernel (``stencil_matvec_soa_stream.launches``) or
    raise."""
    if _on_cpu(blocks, x, "stencil_matvec_soa_stream"):
        return stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd)
    KI, KD = check_kernel_case(blocks, kron, x, offsets, bi, bd, shapes=SCHEDULE_SHAPES)
    y = _launch("sbt_stencil_soa_stream", blocks, kron, x, offsets, bi, bd, KI, KD)
    stencil_matvec_soa_stream.launches += 1
    return y


#: launches of each route, and of each route by (KI, KD, BI, BD)
stencil_matvec_soa.launches = 0
stencil_matvec_soa.by_shape = collections.Counter()
stencil_matvec_soa_rt.launches = 0
stencil_matvec_soa_rt.by_shape = collections.Counter()
stencil_matvec_soa_xin.launches = 0
stencil_matvec_soa_stream.launches = 0
