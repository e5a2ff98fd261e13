"""Block-sparse lattice operators in the structure-of-arrays layout
(counterpart of the ``stencil_soa`` mode of ``superbblas_tpu/bsr.py``).

The operator stores one colour block per direction and site,
``blocks [ndir, BI*BD, *lat]`` (split complex), and optional spin factors
shared by all sites, ``kron [ndir, KI, KD]``; its matvec is the stencil
kernel of ``ops/stencil.py`` on operands ``[ncols, KD*BD, *lat]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import cplx
from .cplx import CArray
from .labels import Coor, volume
from .ops.stencil import soa_eligible, stencil_matvec_soa

__all__ = ["BSROperator", "bsr_from_stencil", "bsr_cast_storage",
           "apply_stencil_soa", "operator_from_numpy"]


def _coor(v) -> Coor:
    return (int(v),) if isinstance(v, (int, np.integer)) else tuple(int(a) for a in v)


class BSROperator(nn.Module):
    """A nearest-neighbour lattice operator in the SoA layout.

    ``blocks``/``kron`` are held as buffers (``blocks_re``, ``blocks_im``,
    ``kron_re``, ``kron_im``), so ``.to(device)`` moves them; ``offsets[d]``
    is the lattice offset of direction d (domain site = image site +
    offset, toroidal); ``bi``/``bd``/``ki``/``kd`` are the block and spin
    factor extents.  ``forward(x)`` is ``apply_stencil_soa``."""

    mode = "stencil_soa"

    def __init__(self, blocks: CArray, kron: Optional[CArray],
                 offsets: Sequence[Coor], dim: Sequence[int], bi, bd,
                 ki=(), kd=(), oim: str = "", odm: str = ""):
        super().__init__()
        self.register_buffer("blocks_re", blocks.re)
        self.register_buffer("blocks_im", blocks.im)
        self.register_buffer("kron_re", None if kron is None else kron.re)
        self.register_buffer("kron_im", None if kron is None else kron.im)
        self.offsets = tuple(tuple(int(v) for v in o) for o in offsets)
        self.dim_i = self.dim_d = tuple(int(v) for v in dim)
        self.bi, self.bd = _coor(bi), _coor(bd)
        self.ki, self.kd = _coor(ki), _coor(kd)
        self.oim, self.odm = oim, odm

    @property
    def blocks(self) -> CArray:
        return CArray(self.blocks_re, self.blocks_im)

    @property
    def kron(self) -> Optional[CArray]:
        return None if self.kron_re is None else CArray(self.kron_re, self.kron_im)

    @property
    def ndir(self) -> int:
        return self.blocks_re.shape[0]

    def replace(self, **changes) -> "BSROperator":
        """A new operator with some of blocks, kron and offsets replaced."""
        kw = dict(blocks=self.blocks, kron=self.kron, offsets=self.offsets,
                  dim=self.dim_i, bi=self.bi, bd=self.bd, ki=self.ki,
                  kd=self.kd, oim=self.oim, odm=self.odm)
        kw.update(changes)
        return BSROperator(**kw)

    def flops_per_matvec(self, ncols: int, complex_dtype: bool = True) -> int:
        """FLOP model of ``superbblas_tpu.bsr.BSROperator.flops_per_matvec``."""
        mul = 8 if complex_dtype else 2
        voli = volume(self.dim_i)
        BI, BD = volume(self.bi), volume(self.bd)
        if self.kron_re is None:
            return mul * voli * self.ndir * BI * BD * ncols
        KI, KD = volume(self.ki), volume(self.kd)
        # stage 1 contracts colour for each kd; stage 2 applies the kron factor
        return mul * voli * self.ndir * ncols * (BI * BD * KD + KI * KD * BI)

    def memops_per_matvec(self, ncols: int, itemsize: int) -> int:
        """Bytes model of ``superbblas_tpu.bsr.BSROperator.memops_per_matvec``
        (blocks counted once per part, as there)."""
        voli, vold = volume(self.dim_i), volume(self.dim_d)
        BI, BD = volume(self.bi), volume(self.bd)
        KI = volume(self.ki) if self.kron_re is not None else 1
        KD = volume(self.kd) if self.kron_re is not None else 1
        blocks_bytes = self.blocks_re.numel() * itemsize
        x_bytes = vold * BD * KD * ncols * itemsize
        y_bytes = voli * BI * KI * ncols * itemsize
        return blocks_bytes + x_bytes + y_bytes

    def forward(self, x: CArray) -> CArray:
        return apply_stencil_soa(self, x)


def bsr_cast_storage(op: BSROperator, dtype) -> BSROperator:
    """Re-store an operator's blocks in ``dtype`` (e.g. bf16: the kernel
    converts loads and accumulates in f32); kron factors keep their
    precision."""
    return op.replace(blocks=cplx.cmap(lambda a: a.to(dtype), op.blocks))


def bsr_from_stencil(
    oim: str,
    odm: str,
    dim_lat: Sequence[int],
    block_i: dict,
    block_d: dict,
    offsets: Sequence[Coor],
    blocks,
    kron=None,
    kron_i: Optional[dict] = None,
    kron_d: Optional[dict] = None,
    layout: str = "soa",
    device="cuda",
) -> BSROperator:
    """Constructor for a regular stencil operator.

    ``blocks``: [*lat, ndir, BI, BD] (flattened block dims), a CArray of
    numpy arrays or tensors, or a complex array.  ``kron``: [ndir, KI, KD]
    or None.  Only ``layout="soa"`` is ported.  The operator is built on
    ``device``: the card unless the caller names the CPU."""
    if layout != "soa":
        raise NotImplementedError(
            f"layout={layout!r}: only 'soa' is ported (AoS stencil and gather "
            "modes: still to port, ROADMAP.md Queue 1 item 3)")
    nlat = len(dim_lat)
    bi_v = volume(block_i.values())
    bd_v = volume(block_d.values())
    if not soa_eligible(offsets, dim_lat):
        raise ValueError("stencil not eligible for the SoA layout")
    perm = (nlat, nlat + 1, nlat + 2) + tuple(range(nlat))
    blocks = cplx.cmap(
        lambda a: torch.as_tensor(a, device=device).permute(perm).reshape(
            (a.shape[nlat], bi_v * bd_v) + tuple(dim_lat)).contiguous(),
        cplx.from_complex(blocks))
    if kron is not None:
        kron = cplx.cmap(lambda a: torch.as_tensor(a, device=device).contiguous(),
                         cplx.from_complex(kron))
    blk_i = "".join(c for c in oim if c in block_i)
    blk_d = "".join(c for c in odm if c in block_d)
    kron_i_s = "".join(c for c in oim if c in (kron_i or {}))
    kron_d_s = "".join(c for c in odm if c in (kron_d or {}))
    return BSROperator(
        blocks, kron, offsets, dim_lat,
        bi=tuple(block_i[c] for c in blk_i), bd=tuple(block_d[c] for c in blk_d),
        ki=tuple(kron_i[c] for c in kron_i_s) if kron_i else (),
        kd=tuple(kron_d[c] for c in kron_d_s) if kron_d else (),
        oim=oim, odm=odm)


def operator_from_numpy(blocks_re: np.ndarray, blocks_im: np.ndarray,
                        kron_re: Optional[np.ndarray],
                        kron_im: Optional[np.ndarray],
                        offsets: Sequence[Coor], dim: Sequence[int],
                        bi, bd, ki=(), kd=(), device="cuda",
                        storage_dtype=None) -> BSROperator:
    """The port's operator from the arrays of a ``superbblas_tpu`` SoA
    operator (``blocks.re/.im`` [ndir, BI*BD, *lat], ``kron.re/.im`` or
    None, ``offsets``, ``dim_i``, ``bi``, ``bd``, ``ki``, ``kd``): both
    packages then compute the same operator."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    kron = None if kron_re is None else CArray(t(kron_re), t(kron_im))
    op = BSROperator(CArray(t(blocks_re), t(blocks_im)), kron, offsets, dim,
                     bi, bd, ki, kd)
    return op if storage_dtype is None else bsr_cast_storage(op, storage_dtype)


def apply_stencil_soa(op: BSROperator, x_soa: CArray,
                      packed_parity: Optional[int] = None) -> CArray:
    """SoA stencil matvec: ``x_soa`` [ncols, KD*BD, *lat] ->
    [ncols, KI*BI, *lat]; the CUDA kernel for CUDA operands, the plain
    version for CPU operands."""
    if op.mode != "stencil_soa":
        raise ValueError("operator was not built with layout='soa'")
    return stencil_matvec_soa(op.blocks, op.kron, x_soa, op.offsets,
                              volume(op.bi), volume(op.bd),
                              packed_parity=packed_parity)
