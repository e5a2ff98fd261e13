"""Block-sparse lattice operators (counterpart of ``superbblas_tpu/bsr.py``).

Three storage modes:

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
* ``"gather"`` (irregular neighbour lists): ``blocks [*lat_i, nnz, BI,
  BD]`` (padded slots zero), ``jj_flat [voli, nnz]`` flat domain sites,
  ``row_counts [voli]``.  ``_apply_gather`` gathers the operand rows and
  runs ONE batched product [voli, BI, nnz*BD] @ [voli, nnz*BD, N] through
  ``ops/batched_gemm.py``, on blocks stored in that product's layout
  (``blocks`` reads them back as the reference's view, without a copy),
  the blocks' two Gauss sums made at the first apply and held on the
  operator (the multigrid's coarse operators are applied many times);
  ``_apply_gather_kron`` contracts colour for each (site, slot) as one
  batched product, then the spin factors.

``create_bsr`` builds an operator from the reference's per-row neighbour
lists (``ii``/``jj``) and picks the mode as the JAX package does: a
uniform stencil, a near-uniform pattern merged into a stencil with zero
blocks, else a gather plan; ``create_kron_bsr`` adds spin factors.
``bsr_krylov`` applies any mode to fields in any label order, with
``alpha``/``beta``/``y`` and operator powers (``okr``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import cplx
from .cplx import CArray
from .labels import Coor, check_order, volume
from .ops._guard import is_sharded
from .ops.batched_gemm import batched_small_gemm
from .ops.copy import _is_static, local_permute
from .ops.stencil import aos_to_soa, soa_eligible, soa_to_aos, stencil_matvec_soa
from .utils.tracker import tracked as _tracked

__all__ = ["BSROperator", "bsr_from_stencil", "bsr_cast_storage",
           "apply_stencil_soa", "operator_from_numpy", "bsr_krylov",
           "bsr_get_preferred_layout", "bsr_allowed_layouts", "create_bsr",
           "create_kron_bsr"]

MODES = ("stencil", "stencil_soa", "gather")


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
    """A lattice operator in mode ``"stencil"`` (AoS blocks ``[*lat, ndir,
    BI, BD]``), ``"stencil_soa"`` (blocks ``[ndir, BI*BD, *lat]``) or
    ``"gather"`` (AoS blocks ``[*lat_i, nnz, BI, BD]`` with ``jj_flat``
    [voli, nnz] flat domain sites and ``row_counts`` [voli] valid slots a
    row; without spin factors the buffers hold them in the gather
    product's layout [voli, BI, nnz*BD], which ``blocks`` views back as
    ``[*lat_i, nnz, BI, BD]``).

    ``blocks``/``kron`` are held as buffers (``blocks_re``, ``blocks_im``,
    ``kron_re``, ``kron_im``; an ``_im`` of None marks real AoS data), and
    so are ``jj_flat`` (int64) and ``row_counts`` (int32), so
    ``.to(device)`` moves them; ``offsets[d]`` is the lattice offset of
    direction d (domain site = image site + offset, toroidal; none in
    gather mode); ``dim`` the image lattice and ``dim_d`` the domain one
    (``dim`` where None); ``bi``/``bd``/``ki``/``kd`` are the block and
    spin factor extents; ``oim``/``odm`` the image and domain labels, of
    which ``blk_*`` and ``kron_*`` are the block and spin labels and
    ``lat_*`` the rest.  ``forward(x)`` is ``apply_stencil_soa`` for SoA
    operators."""

    def __init__(self, blocks, kron, offsets: Sequence[Coor], dim: Sequence[int],
                 bi, bd, ki=(), kd=(), oim: str = "", odm: str = "",
                 mode: str = "stencil_soa", blk_i: str = "", blk_d: str = "",
                 kron_i: str = "", kron_d: str = "", dim_d: Optional[Sequence[int]] = None,
                 jj_flat: Optional[torch.Tensor] = None,
                 row_counts: Optional[torch.Tensor] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        if (mode == "gather") != (jj_flat is not None):
            raise ValueError("jj_flat is given in gather mode and only there")
        self.mode = mode
        self.dim_i = tuple(int(v) for v in dim)
        b = cplx.from_complex(blocks) if mode == "stencil_soa" else blocks
        if mode == "gather":
            lay = _gather_layout if kron is None else torch.Tensor.contiguous
            b = cplx.cmap(lay, b) if cplx.is_carray(b) else lay(b)
        self.register_buffer("blocks_re", b.re if cplx.is_carray(b) else b)
        self.register_buffer("blocks_im", b.im if cplx.is_carray(b) else None)
        self.register_buffer("kron_re", None if kron is None else
                             (kron.re if cplx.is_carray(kron) else kron))
        self.register_buffer("kron_im", kron.im if cplx.is_carray(kron) else None)
        self.register_buffer("jj_flat", jj_flat)
        self.register_buffer("row_counts", row_counts)
        self.offsets = tuple(tuple(int(v) for v in o) for o in offsets)
        self.dim_d = self.dim_i if dim_d is None else tuple(int(v) for v in dim_d)
        self.bi, self.bd = _coor(bi), _coor(bd)
        self.ki, self.kd = _coor(ki), _coor(kd)
        self.oim, self.odm = oim, odm
        self.blk_i, self.blk_d, self.kron_i, self.kron_d = blk_i, blk_d, kron_i, kron_d
        self.lat_i = "".join(c for c in oim if c not in blk_i + kron_i)
        self.lat_d = "".join(c for c in odm if c not in blk_d + kron_d)

    @property
    def blocks(self):
        if self.mode == "gather" and self.kron_re is None:
            def view(a):
                BI, BD = volume(self.bi), volume(self.bd)
                return a.view(a.shape[0], BI, -1, BD).transpose(1, 2).reshape(
                    self.dim_i + (self.ndir, BI, BD))
        else:
            def view(a):
                return a
        if self.blocks_im is None:
            return view(self.blocks_re)
        return CArray(view(self.blocks_re), view(self.blocks_im))

    @property
    def kron(self):
        if self.kron_re is None or self.kron_im is None:
            return self.kron_re
        return CArray(self.kron_re, self.kron_im)

    @property
    def ndir(self) -> int:
        if self.mode == "stencil_soa":
            return self.blocks_re.shape[0]
        if self.mode == "gather":
            return self.jj_flat.shape[1]
        return self.blocks_re.shape[len(self.dim_i)]

    def replace(self, **changes) -> "BSROperator":
        """A new operator with some of its arguments replaced; a new ``dim``
        alone sets both lattices."""
        kw = dict(blocks=self.blocks, kron=self.kron, offsets=self.offsets,
                  dim=self.dim_i, bi=self.bi, bd=self.bd, ki=self.ki,
                  kd=self.kd, oim=self.oim, odm=self.odm, mode=self.mode,
                  blk_i=self.blk_i, blk_d=self.blk_d, kron_i=self.kron_i,
                  kron_d=self.kron_d, dim_d=self.dim_d, jj_flat=self.jj_flat,
                  row_counts=self.row_counts)
        if "dim" in changes and "dim_d" not in changes:
            kw["dim_d"] = None
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


def _gather_layout(a: torch.Tensor) -> torch.Tensor:
    """Gather blocks [*lat_i, nnz, BI, BD] in the gather product's layout
    [voli, BI, nnz*BD] (contiguous; no copy where ``a`` is a view of that
    layout, as ``BSROperator.blocks`` gives)."""
    nnz, BI, BD = a.shape[-3:]
    return a.reshape(-1, nnz, BI, BD).transpose(1, 2).reshape(-1, BI, nnz * BD).contiguous()


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


def _block_labels(o: str, block: Sequence[int]) -> Tuple[str, Coor]:
    """(block labels, block dims) of full labels given the reference-style
    block extent vector (1 for lattice dims)."""
    return ("".join(c for c, b in zip(o, block) if b > 1),
            tuple(int(b) for b in block if b > 1))


def _c_strides(dims: Sequence[int]) -> np.ndarray:
    """Row-major strides of a lattice, int64."""
    strides = np.ones(len(dims), dtype=np.int64)
    for a in range(len(dims) - 2, -1, -1):
        strides[a] = strides[a + 1] * dims[a + 1]
    return strides


def create_bsr(
    oim: str,
    dim_im: Sequence[int],
    odm: str,
    dim_dm: Sequence[int],
    block_im: Sequence[int],
    block_dm: Sequence[int],
    ii: np.ndarray,
    jj: np.ndarray,
    values,
    block_image_fast: bool = False,
    pattern_merge: bool = True,
    device="cuda",
) -> BSROperator:
    """Reference-parity constructor (create_bsr, bsr.h:2287-2320).

    * ``oim``/``dim_im``: image labels and extents (block dims included);
      ``block_im`` gives the block extent per label (1 on lattice dims).
    * ``ii``: [*lat_i] per-row nonzero counts (host numpy).
    * ``jj``: [*lat_i, max_nnz, nlat] absolute domain lattice coordinates
      of each nonzero block (host numpy).
    * ``values``: [*lat_i, max_nnz, BI, BD] blocks ([..., BD, BI] when
      ``block_image_fast``): a CArray, a complex or a real array or tensor.

    The structure is detected as in the JAX package, fastest first: a
    uniform stencil (the same offsets in the same slots on every row) in
    mode "stencil"; with ``pattern_merge``, a near-uniform one (the union
    of the rows' offsets at most 2 max_nnz) scatter-merged into that union
    with zero blocks where a row lacks an offset and duplicate offsets of
    a row summed, in mode "stencil"; else a gather plan, padded blocks
    zeroed.  The detection runs in numpy on ``ii``/``jj``; the blocks are
    formed on ``device`` (the card unless the caller names the CPU)."""
    check_order(oim)
    check_order(odm)
    blk_i, bi = _block_labels(oim, block_im)
    blk_d, bd = _block_labels(odm, block_dm)
    dim_i = tuple(int(d) for d, b in zip(dim_im, block_im) if b == 1)
    dim_d = tuple(int(d) for d, b in zip(dim_dm, block_dm) if b == 1)
    nlat = len(dim_i)
    BI, BD = volume(bi), volume(bd)

    ii = np.asarray(ii).reshape(dim_i)
    jj = np.asarray(jj).reshape(dim_i + (-1, nlat))
    max_nnz = jj.shape[-2]
    values = _to_device(values, device)

    def shape_values(v):
        if block_image_fast:
            v = v.transpose(-1, -2)
        return v.reshape(dim_i + (max_nnz, BI, BD))

    values = cplx.cmap(shape_values, values) if cplx.is_carray(values) \
        else shape_values(values)
    common = dict(offsets=(), dim=dim_i, dim_d=dim_d, bi=bi, bd=bd, oim=oim, odm=odm,
                  blk_i=blk_i, blk_d=blk_d)

    first = int(ii.reshape(-1)[0])
    uniform = bool((ii == first).all()) and first == max_nnz
    rel = None
    if dim_i == dim_d and (uniform or pattern_merge):
        site_coords = np.stack(np.meshgrid(*[np.arange(d) for d in dim_i], indexing="ij"),
                               axis=-1)                          # [*lat, nlat]
        rel = (jj - site_coords[..., None, :]) % np.asarray(dim_i)
        if uniform:
            head = rel.reshape(-1, max_nnz, nlat)[0]
            if (rel == head).all():
                offsets = tuple(tuple(int(v) for v in head[k]) for k in range(max_nnz))
                return BSROperator(values, None, mode="stencil",
                                   **{**common, "offsets": offsets})

    if pattern_merge and rel is not None:
        # near-uniform: offsets encoded to scalar keys; np.unique gives the
        # union, searchsorted each entry's slot
        voli = volume(dim_i)
        rel_f = rel.reshape(voli, max_nnz, nlat).astype(np.int64)
        valid = np.arange(max_nnz)[None, :] < ii.reshape(-1)[:, None]
        keys = (rel_f * _c_strides(dim_i)).sum(-1)
        uniq = np.unique(keys[valid]) if valid.any() else np.zeros(0, np.int64)
        P = len(uniq)
        if 0 < P <= 2 * max_nnz:
            pattern = tuple(tuple(int(v) for v in np.unravel_index(k, dim_i)) for k in uniq)
            slot = np.searchsorted(uniq, keys)
            slot[~valid] = P                                     # the pad bucket
            flat = (np.arange(voli)[:, None] * (P + 1) + slot).reshape(-1)

            def merge(v):
                idx = torch.as_tensor(flat, device=v.device)
                big = torch.zeros((voli * (P + 1), BI, BD), dtype=v.dtype, device=v.device)
                big.index_add_(0, idx, v.reshape(-1, BI, BD))
                return big.reshape(voli, P + 1, BI, BD)[:, :P].reshape(
                    dim_i + (P, BI, BD)).contiguous()

            merged = cplx.cmap(merge, values) if cplx.is_carray(values) else merge(values)
            return BSROperator(merged, None, mode="stencil", **{**common, "offsets": pattern})

    # gather plan: flat domain sites, padded blocks zeroed so the apply
    # ignores the row counts
    jj_flat = (jj % np.asarray(dim_d) * _c_strides(dim_d)).sum(-1).reshape(-1, max_nnz)
    nnz_mask = np.arange(max_nnz)[None, :] < ii.reshape(-1)[:, None]
    sample = values.re if cplx.is_carray(values) else values
    mask = torch.as_tensor(nnz_mask.reshape(dim_i + (max_nnz, 1, 1)), device=sample.device)

    def zero_pads(v):
        return torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=v.device))

    values = cplx.cmap(zero_pads, values) if cplx.is_carray(values) else zero_pads(values)
    return BSROperator(
        values, None, mode="gather",
        jj_flat=torch.as_tensor(jj_flat.astype(np.int64), device=sample.device),
        row_counts=torch.as_tensor(ii.reshape(-1).astype(np.int32), device=sample.device),
        **common)


def create_kron_bsr(
    oim: str,
    dim_im: Sequence[int],
    odm: str,
    dim_dm: Sequence[int],
    block_im: Sequence[int],
    block_dm: Sequence[int],
    kron_im: Sequence[int],
    kron_dm: Sequence[int],
    ii: np.ndarray,
    jj: np.ndarray,
    values,
    kron_values,
    block_image_fast: bool = False,
    device="cuda",
) -> BSROperator:
    """Kronecker-factored BSR (create_kron_bsr, bsr.h:2302-2336): each
    nonzero block is kron(spin factor, colour block); spin factors depend
    only on the slot, colour blocks on (site, slot).

    ``kron_im``/``kron_dm``: per-label kron-block extents (1 elsewhere).
    ``kron_values``: [nnz, KI, KD] ([nnz, KD, KI] if ``block_image_fast``).
    No pattern merge: the spin factor of slot k applies to every row's
    k-th neighbour, a pairing a merge would break; a uniform structure
    gives mode "stencil", any other a gather plan."""
    base = create_bsr(
        "".join(c for c, k in zip(oim, kron_im) if k == 1),
        [d for d, k in zip(dim_im, kron_im) if k == 1],
        "".join(c for c, k in zip(odm, kron_dm) if k == 1),
        [d for d, k in zip(dim_dm, kron_dm) if k == 1],
        [b for b, k in zip(block_im, kron_im) if k == 1],
        [b for b, k in zip(block_dm, kron_dm) if k == 1],
        ii, jj, values, block_image_fast, pattern_merge=False, device=device)
    kron_i = "".join(c for c, k in zip(oim, kron_im) if k > 1)
    kron_d = "".join(c for c, k in zip(odm, kron_dm) if k > 1)
    ki = tuple(int(k) for k in kron_im if k > 1)
    kd = tuple(int(k) for k in kron_dm if k > 1)
    kv = _to_device(kron_values, device)

    def shape_kron(v):
        if block_image_fast:
            return v.reshape(-1, volume(kd), volume(ki)).transpose(-1, -2).contiguous()
        return v.reshape(-1, volume(ki), volume(kd))

    kv = cplx.cmap(shape_kron, kv) if cplx.is_carray(kv) else shape_kron(kv)
    return base.replace(kron=kv, oim=oim, odm=odm, kron_i=kron_i, kron_d=kron_d,
                        ki=ki, kd=kd)


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


@_tracked("apply_stencil_soa",
          flops_fn=lambda out, op, x_soa, *a, **k:
          op.flops_per_matvec(x_soa.shape[0], True),
          memops_fn=lambda out, op, x_soa, *a, **k:
          op.memops_per_matvec(x_soa.shape[0], 8))
def apply_stencil_soa(op: BSROperator, x_soa: CArray, interpret: Optional[bool] = None,
                      packed_parity: Optional[int] = None) -> CArray:
    """SoA stencil matvec: ``x_soa`` [ncols, KD*BD, *lat] ->
    [ncols, KI*BI, *lat]; the CUDA kernel for CUDA operands, the plain
    version for CPU operands.  ``interpret`` (the Pallas interpreter's
    switch in the JAX package) is accepted and unused.  A sharded field
    (DTensors) goes to ``parallel.apply_stencil_soa_sharded``, which runs
    the kernel on each rank's halo-extended shard."""
    if op.mode != "stencil_soa":
        raise ValueError("operator was not built with layout='soa'")
    if is_sharded(x_soa, op.blocks_re):
        from .parallel.dispatch import apply_stencil_soa_dtensor

        return apply_stencil_soa_dtensor(op, x_soa, packed_parity)
    return stencil_matvec_soa(op.blocks, op.kron, x_soa, op.offsets,
                              volume(op.bi), volume(op.bd),
                              packed_parity=packed_parity)


def bsr_get_preferred_layout(op: BSROperator) -> Tuple[str, str]:
    """The x and y label orders :func:`bsr_krylov` takes with no data
    movement ('n' stands for the caller's column labels): lattice, kron and
    block labels, columns innermost for "stencil" and "gather"; columns
    outermost, then
    kron and block labels, then lattice for "stencil_soa" (fields in that
    order reach the stencil kernel by reshape alone)."""
    if op.mode == "stencil_soa":
        return ("n" + op.kron_d + op.blk_d + op.lat_d,
                "n" + op.kron_i + op.blk_i + op.lat_i)
    return (op.lat_d + op.kron_d + op.blk_d + "n",
            op.lat_i + op.kron_i + op.blk_i + "n")


def bsr_allowed_layouts(op: BSROperator) -> dict:
    """Which field layouts each mode runs and at what cost (the
    SpMMAllowedLayout negotiation of bsr.h:255-260): ``preferred`` is the
    one zero-copy (ox, oy) pair, ``zero_copy`` every such pair, and
    ``any_order`` True: other label orders pay one permutation a side."""
    pref = bsr_get_preferred_layout(op)
    return {"mode": op.mode, "preferred": pref, "zero_copy": (pref,), "any_order": True}


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


def _gather_rows(xc, op: BSROperator, inner: Tuple[int, ...]):
    """The operand rows of each (site, slot): ``xc`` [*lat_d, *inner] ->
    [voli * nnz, *inner], an index_select of the flattened lattice."""
    idx = op.jj_flat.reshape(-1)

    def g(a):
        return a.reshape((-1,) + inner).index_select(0, idx)

    return cplx.cmap(g, xc) if cplx.is_carray(xc) else g(xc)


def _apply_gather(op: BSROperator, xc):
    """General BSR matvec on irregular neighbour lists: xc [*lat_d, BD, N]
    -> [*lat_i, BI, N], as ONE split-complex batched product [voli, BI,
    nnz*BD] @ [voli, nnz*BD, N] through ``batched_small_gemm`` (K3 for
    nnz*BD <= 64, E1 above), on the blocks as the operator stores them."""
    BD, N = xc.shape[-2], xc.shape[-1]
    voli, nnz, BI = volume(op.dim_i), op.ndir, volume(op.bi)
    xdt = xc.dtype
    acc = _acc_dtype(torch.promote_types(op.blocks_re.dtype, xdt))
    xg = _reshape(_gather_rows(xc, op, (BD, N)), (voli, nnz * BD, N))

    def f(bb, xx):
        return batched_small_gemm(bb.to(acc), xx.to(acc))

    if op.blocks_im is not None and cplx.is_carray(xg):
        # cbilinear's three Gauss products, the blocks' sums held
        s, d = _gauss_blocks(op)
        k1 = f(op.blocks_re, xg.re + xg.im)
        y = CArray(k1 - f(s, xg.im), k1 + f(d, xg.re))
    else:
        b = op.blocks_re if op.blocks_im is None else CArray(op.blocks_re, op.blocks_im)
        y = cplx.cbilinear(f, b, xg)
    return _astype(_reshape(y, tuple(op.dim_i) + (BI, N)), xdt)


def _gauss_blocks(op: BSROperator):
    """(re + im, im - re) of a gather operator's blocks, the two sums
    ``cplx.cbilinear`` forms on every product: made at the first apply and
    held on the operator, made again after an in-place change of its
    blocks (the key holds the block tensors themselves and their
    versions)."""
    re, im = op.blocks_re, op.blocks_im
    held = op.__dict__.get("_gauss")
    if held is None or held[0] is not re or held[1] is not im \
            or held[2] != (re._version, im._version):
        held = (re, im, (re._version, im._version), re + im, im - re)
        op.__dict__["_gauss"] = held
    return held[3], held[4]


def _apply_gather_kron(op: BSROperator, xc):
    """Kronecker-factored matvec on irregular neighbour lists (bsr.h:398-451):
    xc [*lat_d, KD, BD, N] -> [*lat_i, KI, BI, N].  Stage 1 contracts
    colour for each (site, slot) as one batched product [voli*nnz, BI, BD]
    @ [voli*nnz, BD, KD*N] (K3 for BI, BD <= 64); stage 2 applies the spin
    factor of each slot, summed over slot and KD (``torch.einsum``).
    Padded slots carry zero colour blocks and add nothing."""
    KD, BD, N = xc.shape[-3], xc.shape[-2], xc.shape[-1]
    voli, nnz, BI = volume(op.dim_i), op.ndir, volume(op.bi)
    xdt = xc.dtype
    acc = _acc_dtype(torch.promote_types(op.blocks_re.dtype, xdt))
    xg = _gather_rows(xc, op, (KD, BD, N))                   # [voli*nnz, KD, BD, N]
    xg = cplx.cmap(lambda a: a.transpose(1, 2).reshape(voli * nnz, BD, KD * N), xg) \
        if cplx.is_carray(xg) else xg.transpose(1, 2).reshape(voli * nnz, BD, KD * N)
    b = _reshape(op.blocks, (voli * nnz, BI, BD))
    t = cplx.cbilinear(lambda bb, xx: batched_small_gemm(bb.to(acc), xx.to(acc)), b, xg)
    t = _reshape(t, (voli, nnz, BI, KD, N))

    def spin(kk, tt):
        dt = torch.promote_types(kk.dtype, tt.dtype)
        with cplx._full_f32():
            return torch.einsum("kab,vkibn->vain", kk.to(dt), tt.to(dt))

    y = cplx.cbilinear(spin, op.kron, t)                       # [voli, KI, BI, N]
    return _astype(_reshape(y, tuple(op.dim_i) + (volume(op.ki), BI, N)), xdt)


def _zeros_im(x) -> CArray:
    return x if cplx.is_carray(x) else CArray(x, torch.zeros_like(x))


def _bsr_flops(out, alpha, op, x, ox, *a, **k):
    """The tracker's flop attribution of one :func:`bsr_krylov` call."""
    cols = "".join(c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
    ncols = 1
    for c in cols:
        ncols *= x.shape[ox.index(c)]
    power = k.get("power", 1)
    return op.flops_per_matvec(ncols, cplx.is_carray(op.blocks)) * power


@_tracked("bsr_krylov", flops_fn=_bsr_flops)
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
    pays one permutation a side.  Sharded operands (DTensors, or CArrays
    of them) go to the ``parallel`` function of the operator's mode
    (``parallel.dispatch``); the result is sharded as x."""
    if is_sharded(x, op.blocks_re):
        from .parallel.dispatch import bsr_krylov_dtensor

        return bsr_krylov_dtensor(alpha, op, x, ox, beta, y, oy, okr, power)
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
        elif op.mode == "stencil":
            apply_fn = _apply_stencil
        else:
            apply_fn = _apply_gather_kron if kron else _apply_gather

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
