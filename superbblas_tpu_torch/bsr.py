"""Block-sparse lattice operators (counterpart of ``superbblas_tpu/bsr.py``).

Two storage modes of a regular nearest-neighbour stencil:

* ``"stencil"`` (AoS, label order): ``blocks [*lat, ndir, BI, BD]``,
  optional spin factors ``kron [ndir, KI, KD]``.  The matvec
  ``_apply_stencil`` rolls the operand to each neighbour; without spin
  factors it stacks the ndir shifted operands and runs ONE split-complex
  batched product per apply through ``ops/batched_gemm.py`` (the coarse
  operators of multigrid); with them it contracts colour, then spin, per
  direction (``torch.einsum``).
* ``"stencil_soa"`` (structure of arrays): ``blocks [ndir, BI*BD, *lat]``
  (split complex); the matvec is the stencil kernel of ``ops/stencil.py``
  on operands ``[ncols, KD*BD, *lat]``.

``bsr_krylov`` applies either to fields in any label order, with
``alpha``/``beta``/``y`` and operator powers (``okr``).  The gather modes
of irregular operators (``create_bsr``, ``create_kron_bsr``) are still to
port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import cplx
from .cplx import CArray
from .labels import Coor, check_order, volume
from .ops.batched_gemm import batched_small_gemm
from .ops.copy import _is_static, local_permute
from .ops.stencil import aos_to_soa, soa_eligible, soa_to_aos, stencil_matvec_soa

__all__ = ["BSROperator", "bsr_from_stencil", "bsr_cast_storage",
           "apply_stencil_soa", "operator_from_numpy", "bsr_krylov",
           "bsr_get_preferred_layout", "create_bsr", "create_kron_bsr"]

_GATHER_TODO = ("the gather modes of irregular operators (create_bsr, "
                "create_kron_bsr, _apply_gather*) are still to port: ROADMAP.md "
                "Queue 1 item 3")


def _coor(v) -> Coor:
    return (int(v),) if isinstance(v, (int, np.integer)) else tuple(int(a) for a in v)


def _idx(a, index):
    """Index that works for plain tensors and split-complex CArrays."""
    return cplx.cmap(lambda v: v[index], a) if cplx.is_carray(a) else a[index]


def _stack(arrs, axis):
    if cplx.is_carray(arrs[0]):
        return CArray(torch.stack([a.re for a in arrs], dim=axis),
                      torch.stack([a.im for a in arrs], dim=axis))
    return torch.stack(arrs, dim=axis)


def _reshape(a, shape):
    return cplx.cmap(lambda v: v.reshape(shape), a) if cplx.is_carray(a) \
        else a.reshape(shape)


def _astype(a, dtype):
    return cplx.cmap(lambda v: v.to(dtype), a) if cplx.is_carray(a) else a.to(dtype)


class BSROperator(nn.Module):
    """A nearest-neighbour lattice operator in mode ``"stencil"`` (AoS
    blocks ``[*lat, ndir, BI, BD]``) or ``"stencil_soa"`` (blocks
    ``[ndir, BI*BD, *lat]``).

    ``blocks``/``kron`` are held as buffers (``blocks_re``, ``blocks_im``,
    ``kron_re``, ``kron_im``; an ``_im`` of None marks real AoS data), so
    ``.to(device)`` moves them; ``offsets[d]`` is the lattice offset of
    direction d (domain site = image site + offset, toroidal);
    ``bi``/``bd``/``ki``/``kd`` are the block and spin factor extents;
    ``oim``/``odm`` the image and domain labels, of which ``blk_*`` and
    ``kron_*`` are the block and spin labels and ``lat_*`` the rest.
    ``forward(x)`` is ``apply_stencil_soa`` for SoA operators."""

    def __init__(self, blocks, kron, offsets: Sequence[Coor], dim: Sequence[int],
                 bi, bd, ki=(), kd=(), oim: str = "", odm: str = "",
                 mode: str = "stencil_soa", blk_i: str = "", blk_d: str = "",
                 kron_i: str = "", kron_d: str = ""):
        super().__init__()
        if mode not in ("stencil", "stencil_soa"):
            raise NotImplementedError(f"mode {mode!r}: {_GATHER_TODO}")
        self.mode = mode
        b = cplx.from_complex(blocks) if mode == "stencil_soa" else blocks
        self.register_buffer("blocks_re", b.re if cplx.is_carray(b) else b)
        self.register_buffer("blocks_im", b.im if cplx.is_carray(b) else None)
        self.register_buffer("kron_re", None if kron is None else
                             (kron.re if cplx.is_carray(kron) else kron))
        self.register_buffer("kron_im", kron.im if cplx.is_carray(kron) else None)
        self.offsets = tuple(tuple(int(v) for v in o) for o in offsets)
        self.dim_i = self.dim_d = tuple(int(v) for v in dim)
        self.bi, self.bd = _coor(bi), _coor(bd)
        self.ki, self.kd = _coor(ki), _coor(kd)
        self.oim, self.odm = oim, odm
        self.blk_i, self.blk_d, self.kron_i, self.kron_d = blk_i, blk_d, kron_i, kron_d
        self.lat_i = "".join(c for c in oim if c not in blk_i + kron_i)
        self.lat_d = "".join(c for c in odm if c not in blk_d + kron_d)

    @property
    def blocks(self):
        if self.blocks_im is None:
            return self.blocks_re
        return CArray(self.blocks_re, self.blocks_im)

    @property
    def kron(self):
        if self.kron_re is None or self.kron_im is None:
            return self.kron_re
        return CArray(self.kron_re, self.kron_im)

    @property
    def ndir(self) -> int:
        if self.mode == "stencil_soa":
            return self.blocks_re.shape[0]
        return self.blocks_re.shape[len(self.dim_i)]

    def replace(self, **changes) -> "BSROperator":
        """A new operator with some of blocks, kron, offsets and dim replaced."""
        kw = dict(blocks=self.blocks, kron=self.kron, offsets=self.offsets,
                  dim=self.dim_i, bi=self.bi, bd=self.bd, ki=self.ki,
                  kd=self.kd, oim=self.oim, odm=self.odm, mode=self.mode,
                  blk_i=self.blk_i, blk_d=self.blk_d, kron_i=self.kron_i,
                  kron_d=self.kron_d)
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
    """Re-store an operator's blocks in ``dtype`` (e.g. bf16: the kernels
    convert loads and accumulate in f32); kron factors keep their
    precision."""
    return op.replace(blocks=_astype(op.blocks, dtype))


def _to_device(a, device):
    """A CArray of tensors for complex or split input, else a real tensor,
    on ``device``, contiguous."""
    def t(v):
        return torch.as_tensor(v, device=device).contiguous()

    if cplx.is_carray(a):
        return cplx.cmap(t, a)
    if a.is_complex() if isinstance(a, torch.Tensor) else np.iscomplexobj(a):
        return cplx.cmap(t, cplx.from_complex(a))
    return t(a)


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
    layout: str = "aos",
    device="cuda",
) -> BSROperator:
    """Constructor for a regular stencil operator.

    ``blocks``: [*lat, ndir, BI, BD] (flattened block dims), a CArray of
    numpy arrays or tensors, a complex array or a real one.  ``kron``:
    [ndir, KI, KD] or None.  ``layout``: "aos" (label order, any stencil;
    the default, as in the JAX package) or "soa" (the stencil kernel's
    layout, which needs a 4-D lattice and one-hot +-1 offsets).  The operator is built on ``device``: the card unless the
    caller names the CPU."""
    if layout not in ("soa", "aos"):
        raise ValueError(f"layout={layout!r}: 'soa' or 'aos'")
    nlat = len(dim_lat)
    bi_v = volume(block_i.values())
    bd_v = volume(block_d.values())
    blocks = _to_device(blocks, device)
    if kron is not None:
        kron = _to_device(kron, device)
    if layout == "soa":
        if not soa_eligible(offsets, dim_lat, bi_v, bd_v, volume((kron_i or {}).values()),
                            volume((kron_d or {}).values())):
            raise ValueError("stencil not eligible for the SoA layout")
        perm = (nlat, nlat + 1, nlat + 2) + tuple(range(nlat))
        blocks = cplx.cmap(
            lambda a: a.permute(perm).reshape(
                (a.shape[nlat], bi_v * bd_v) + tuple(dim_lat)).contiguous(),
            cplx.from_complex(blocks))
        if kron is not None:
            kron = cplx.from_complex(kron)
    blk_i = "".join(c for c in oim if c in block_i)
    blk_d = "".join(c for c in odm if c in block_d)
    kron_i_s = "".join(c for c in oim if c in (kron_i or {}))
    kron_d_s = "".join(c for c in odm if c in (kron_d or {}))
    return BSROperator(
        blocks, kron, offsets, dim_lat,
        bi=tuple(block_i[c] for c in blk_i), bd=tuple(block_d[c] for c in blk_d),
        ki=tuple(kron_i[c] for c in kron_i_s) if kron_i else (),
        kd=tuple(kron_d[c] for c in kron_d_s) if kron_d else (),
        oim=oim, odm=odm, mode="stencil_soa" if layout == "soa" else "stencil",
        blk_i=blk_i, blk_d=blk_d, kron_i=kron_i_s, kron_d=kron_d_s)


def create_bsr(*args, **kwargs):
    """Reference-parity constructor of irregular operators: still to port."""
    raise NotImplementedError(_GATHER_TODO)


def create_kron_bsr(*args, **kwargs):
    """Kronecker-factored irregular operators: still to port."""
    raise NotImplementedError(_GATHER_TODO)


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


def bsr_get_preferred_layout(op: BSROperator) -> Tuple[str, str]:
    """The x and y label orders :func:`bsr_krylov` takes with no data
    movement ('n' stands for the caller's column labels): lattice, kron and
    block labels, columns innermost for "stencil"; columns outermost, then
    kron and block labels, then lattice for "stencil_soa" (fields in that
    order reach the stencil kernel by reshape alone)."""
    if op.mode == "stencil_soa":
        return ("n" + op.kron_d + op.blk_d + op.lat_d,
                "n" + op.kron_i + op.blk_i + op.lat_i)
    return (op.lat_d + op.kron_d + op.blk_d + "n",
            op.lat_i + op.kron_i + op.blk_i + "n")


def _roll_lat(x, offset, nlat):
    """Toroidal shift of the leading nlat lattice axes by -offset (bring
    the neighbour at +offset to each site)."""
    if cplx.is_carray(x):
        return cplx.cmap(lambda v: _roll_lat(v, offset, nlat), x)
    for ax, off in enumerate(offset):
        if off % x.shape[ax] != 0:
            x = torch.roll(x, -off, dims=ax)
    return x


def _acc_dtype(dt):
    """The type products are formed and summed in: f32 for 16-bit storage."""
    return torch.float32 if dt in (torch.bfloat16, torch.float16) else dt


def _apply_stencil(op: BSROperator, xc, shift=None):
    """Core AoS stencil matvec on canonical operands.

    xc: [*lat_d, KD, BD, N] (KD axis present only in kron mode); returns
    [*lat_i, KI, BI, N].  ``shift(x, off, nlat)`` overrides the toroidal
    roll that fetches the neighbour operand."""
    if shift is None:
        shift = _roll_lat
    nlat = len(op.dim_d)
    xdt = xc.dtype
    acc = _acc_dtype(torch.promote_types(op.blocks_re.dtype, xdt))
    if op.kron_re is None:
        # y[v, i, n] = sum_(k, j) blocks[v, k, i, j] xs_k[v, j, n]: the ndir
        # shifted operands stacked on the contraction axis make ONE batched
        # product with J = ndir*BD, blocks laid out [V, BI, ndir*BD] (a
        # contiguous copy per apply)
        V, ndir = volume(op.dim_d), op.ndir
        BI, BD = volume(op.bi), volume(op.bd)
        xs = _stack([shift(xc, off, nlat) for off in op.offsets], axis=nlat)
        xs = _reshape(xs, (V, ndir * BD, xc.shape[-1]))
        b = cplx.cmap(lambda a: a.reshape(V, ndir, BI, BD).transpose(1, 2)
                      .reshape(V, BI, ndir * BD), op.blocks) \
            if cplx.is_carray(op.blocks) else \
            op.blocks.reshape(V, ndir, BI, BD).transpose(1, 2).reshape(V, BI, ndir * BD)
        y = cplx.cbilinear(lambda bb, xx: batched_small_gemm(bb.to(acc), xx.to(acc)),
                           b, xs)
        return _astype(_reshape(y, tuple(op.dim_i) + (BI, xc.shape[-1])), xdt)

    # kron mode: xc [*lat, KD, BD, N]
    batch = tuple(range(nlat))
    ys = None
    for k, off in enumerate(op.offsets):
        xs = shift(xc, off, nlat)                             # [*lat, KD, BD, N]
        blk = _idx(op.blocks, (slice(None),) * nlat + (k,))   # [*lat, BI, BD]
        t = _astype(cplx.cdot_general(
            blk, xs, (((nlat + 1,), (nlat + 1,)), (batch, batch)),
            preferred_element_type=acc), xdt)                  # [*lat, BI, KD, N]

        def spin(kk, tt):
            dt = torch.promote_types(kk.dtype, tt.dtype)
            with cplx._full_f32():
                return torch.einsum("ab,...ibn->...ian", kk.to(dt), tt.to(dt))

        yk = cplx.cbilinear(spin, _idx(op.kron, k), t)         # [*lat, BI, KI, N]
        ys = yk if ys is None else cplx.add(ys, yk)
    # reorder to [*lat, KI, BI, N]
    return cplx.cmap(lambda v: v.transpose(nlat, nlat + 1), ys) if cplx.is_carray(ys) \
        else ys.transpose(nlat, nlat + 1)


def _zeros_im(x) -> CArray:
    return x if cplx.is_carray(x) else CArray(x, torch.zeros_like(x))


def bsr_krylov(alpha, op: BSROperator, x, ox: str, beta=0.0, y=None,
               oy: Optional[str] = None, okr: Optional[str] = None,
               power: int = 1):
    """Apply the operator: y = alpha * A x + beta * y (bsr_krylov,
    bsr.h:2353-2517 of the reference).

    ``ox`` holds the domain lattice labels, the (kron and) domain block
    labels and any column labels; ``oy`` likewise for the image side.
    With ``okr``, ``oy`` also holds the power label and the result holds
    y_p = alpha * A^{p+1} x for p in [0, power).  ``x`` and ``y`` are
    tensors, CArrays or complex tensors (a complex ``x`` gives a complex
    result).  An SoA operator takes fields in its preferred order
    (:func:`bsr_get_preferred_layout`) by reshape alone; any other order
    pays one permutation a side."""
    check_order(ox)
    user_complex = not cplx.is_carray(x) and x.is_complex()
    if user_complex:
        x = cplx.from_complex(x)
        if y is not None and not cplx.is_carray(y):
            y = cplx.from_complex(y)
    cols = "".join(c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
    if oy is None:
        oy = op.lat_i + op.kron_i + op.blk_i + cols + (okr or "")
    check_order(oy)
    if okr is not None:
        if okr not in oy:
            raise ValueError(f"power label {okr!r} not in oy={oy!r}")
        if y is not None:
            power = y.shape[oy.index(okr)]
    oy_data = "".join(c for c in oy if c != okr)
    if op.mode not in ("stencil", "stencil_soa"):
        raise NotImplementedError(_GATHER_TODO)

    kron = op.kron_re is not None
    KD = volume(op.kd) if kron else 1
    KI = volume(op.ki) if kron else 1
    BD, BI = volume(op.bd), volume(op.bi)
    ki_shape = tuple(op.ki) if kron else ()
    soa_native = (op.mode == "stencil_soa"
                  and ox == cols + op.kron_d + op.blk_d + op.lat_d)
    if soa_native:
        # the field enters the kernel by reshape alone; so does the result
        # when oy is the SoA order too
        xv = _zeros_im(x)
        ncl = len(cols)
        col_shape = tuple(xv.re.shape[:ncl])
        lat_shape_d = tuple(xv.re.shape[ncl + len(op.kron_d) + len(op.blk_d):])
        xc = cplx.cmap(lambda a: a.reshape((volume(col_shape), KD * BD) + lat_shape_d)
                       .contiguous(), xv)
        apply_fn = apply_stencil_soa

        def to_user(yc):
            if oy_data == cols + op.kron_i + op.blk_i + op.lat_i:
                return cplx.cmap(lambda a: a.reshape(
                    col_shape + ki_shape + tuple(op.bi) + tuple(op.dim_i)), yc)
            y_aos = soa_to_aos(yc, len(op.dim_i), KI, BI)
            shape = tuple(op.dim_i) + ki_shape + tuple(op.bi) + col_shape
            return local_permute(_reshape(y_aos, shape),
                                 op.lat_i + op.kron_i + op.blk_i + cols, oy_data)
    else:
        # canonical x: [*lat_d, KD?, BD, N]
        xc = local_permute(x, ox, op.lat_d + op.kron_d + op.blk_d + cols)
        nlat = len(op.dim_d)
        lat_shape = tuple(xc.shape[:nlat])
        ncols = volume(xc.shape[nlat + len(op.kron_d) + len(op.blk_d):])
        xc = _reshape(xc, lat_shape + ((KD,) if kron else ()) + (BD, ncols))
        col_shape = tuple(x.shape[ox.index(c)] for c in cols)

        def to_user(yc):
            shape = tuple(op.dim_i) + ki_shape + tuple(op.bi) + col_shape
            return local_permute(_reshape(yc, shape),
                                 op.lat_i + op.kron_i + op.blk_i + cols, oy_data)

        if op.mode == "stencil_soa":
            def apply_fn(o, v):
                nl = len(o.dim_d)
                v = _zeros_im(v)
                if not kron:
                    v = cplx.cmap(lambda a: a[..., None, :, :], v)
                yv = soa_to_aos(apply_stencil_soa(o, aos_to_soa(v, nl)), nl, KI, BI)
                return yv if kron else cplx.cmap(lambda a: a[..., 0, :, :], yv)
        else:
            apply_fn = _apply_stencil

    if power > 1 and (BI != BD or op.dim_i != op.dim_d or KI != KD):
        raise ValueError(
            "operator powers require a square operator (image and domain "
            "structure must match, as in the reference okr path)")
    outs = []
    cur = xc
    for _ in range(power):
        cur = apply_fn(op, cur)
        outs.append(cur)

    def scale(t):
        return t if (_is_static(alpha) and alpha == 1) else cplx.scale(alpha, t)

    def finish(out):
        return cplx.to_complex(out) if user_complex else out

    if okr is None:
        out = scale(to_user(outs[0]))
        if y is not None and not (_is_static(beta) and beta == 0):
            out = cplx.add(out, cplx.scale(beta, y))
        elif y is not None:
            out = _astype(out, y.dtype)
        return finish(out)
    stacked = _stack([scale(to_user(o)) for o in outs], axis=oy.index(okr))
    if y is not None and not (_is_static(beta) and beta == 0):
        stacked = cplx.add(stacked, cplx.scale(beta, y))
    return finish(stacked)
