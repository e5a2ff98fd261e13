"""Nearest-neighbour block stencil in the structure-of-arrays layout
(counterpart of ``superbblas_tpu/ops/stencil_pallas.py``).

    x       [n, KD*BD, X, Y, Z, T]
    blocks  [ndir, BI*BD, X, Y, Z, T]
    kron    [ndir, KI, KD]           (None: KI = KD = 1, factor 1)
    y       [n, KI*BI, X, Y, Z, T]

``stencil_matvec_soa`` sends CPU tensors to the plain PyTorch version
``stencil_matvec_soa_reference`` and CUDA tensors to the hand-written
kernel K1: at the Wilson and staggered shapes (``TILED_SHAPES``) its
tiled kernel ``csrc/stencil_tiled.cu``, which runs the spin factors from
a plan (``factor_kron``, the TPU kernel's ``_factor_kron``: rank-2
half-spinor projection of the Wilson hops), at the clover term's shape
(``SITE_SHAPE``) the block-streaming kernel ``csrc/stencil_site.cu``
(each block entry streamed into shared memory once for all the columns;
16-byte copies, or element copies where the volume or the pointers are
not aligned for them) at the f32-summed pairs and the templated kernel of
``csrc/stencil_soa.cu`` at f64, and its runtime-shape route
(``stencil_matvec_soa_rt``, ``csrc/stencil_rt.cu`` at the tile ``rt_tile``
picks) at every other shape with KI*KD*BI*BD <= 256, the TPU kernel's
rule; a case no route takes raises.  ``k1_route`` names
the route of a case (``stencil_matvec_soa.by_route`` counts launches by
it).
``stencil_matvec_soa_xin`` and ``stencil_matvec_soa_stream`` compute the
same function with other schedules of the X neighbours
(``csrc/stencil_schedules.cu``: x staged in shared memory, at every shape
and pair K1 takes, with K1's bits: the tiled route's at TILED_SHAPES, the
runtime-shape route's elsewhere); no caller dispatches them.

The tiled route's spin plan is built once per kron value (``spin_plan``,
counted by ``stencil_matvec_soa.plan_builds``) from the kron's host value:
one device-to-host read per kron tensor (``host_kron``,
``stencil_matvec_soa.kron_reads``), none for a kron derived on the device
from one whose value is known (``derive_kron``: the adjoint, the twist,
the packed hops).

Under tracing (``torch.export``, ``torch.compile``) ``stencil_matvec_soa``
is the custom op ``torch.ops.sbt.stencil_matvec_soa``, whose shape-only
fake implementation lets a traced program hold the op and whose real
implementation is the eager call: a loaded exported program launches K1
on CUDA tensors and runs the plain version on CPU ones.  Eager calls
never go through the op.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cplx
from ..cplx import CArray
from ..utils import tracker
from ._guard import refuse_dtensor

__all__ = ["stencil_matvec_soa", "stencil_matvec_soa_reference", "stencil_matvec_soa_rt",
           "stencil_matvec_soa_xin", "stencil_matvec_soa_stream", "schedule_attrs",
           "stencil_matvec_soa_planned", "factor_kron", "spin_plan", "clear_plans",
           "derive_kron", "host_kron", "k1_route", "rt_split", "rt_tile", "rt_attrs",
           "soa_eligible", "aos_to_soa", "soa_to_aos"]

#: (KI, KD, BI, BD) shapes with kernels of their own: Wilson, staggered and
#: the clover term; every other shape takes the runtime-shape route
KERNEL_SHAPES = ((4, 4, 3, 3), (1, 1, 3, 3), (1, 1, 12, 12))
#: the shapes of KERNEL_SHAPES that run the tiled kernel with the spin plan
#: (csrc/stencil_tiled.cu)
TILED_SHAPES = ((4, 4, 3, 3), (1, 1, 3, 3))
#: the clover term's shape: the block-streaming kernel (csrc/stencil_site.cu)
#: at the f32-summed pairs, the templated kernel of csrc/stencil_soa.cu at
#: f64/f64
SITE_SHAPE = (1, 1, 12, 12)
#: bytes of one direction's record of the tiled kernel's plan, by the type
#: its sums run in (csrc/stencil_tiled.cu PlanDir: 4 int32, then 64 values)
PLAN_DIR_BYTES = {torch.float32: 272, torch.float64: 528}
#: most values one column's field, or one direction's blocks, may hold in
#: the tiled kernel (its in-plane offsets are 32-bit; 178956970 sites at
#: 12 values a site)
TILED_MAX_VALUES = 2 ** 31 - 1
#: traffic (bytes) within which a block finds its X neighbours still in L2:
#: a third of the H100's 50 MB (``x_chunk``)
L2_REUSE_BYTES = 16 << 20
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
#: most directions the kernel takes (csrc/stencil_soa.cuh kMaxDirs)
MAX_DIRS = 16
#: shared memory one block may use on the H100 (227 KB)
SMEM_BYTES = 232448
#: shared memory of one of the X-inside kernel's two stages: both within a
#: block's, one block of 512 threads (16 warps) an SM.  At 32^3x64 f32 a
#: stage then holds the X lines of 32 sites of one column, so that a warp
#: reads one X plane; stages of a sixth of the SM's (two blocks of 256
#: threads) hold 8 sites, and ran 1.5x slower (PERF.md)
XIN_STAGE_BYTES = (SMEM_BYTES - 1024) // 2
#: shared memory of the X-streaming kernel's ring of four planes: a quarter
#: of the SM's 228 KB less the 1 KB each block reserves, so that four
#: blocks of STREAM_THREADS (16 warps) share an SM
STREAM_RING_BYTES = (233472 - 4 * 1024) // 4
#: threads a block of the X-streaming kernel (csrc/stencil_schedules.cu)
STREAM_THREADS = 128
#: most threads a block of the runtime-shape route (csrc/stencil_rt.cu
#: SBT_RT_THREADS) and most stages of its ring (kMaxStages); what
#: ``rt_tile`` aims a stage and the ring at: a stage of 48 KB holds the next
#: directions' copies in flight, a ring of 112 KB leaves room for two blocks
#: an SM
RT_THREADS, RT_MAX_STAGES = 256, 8
RT_STAGE_BYTES, RT_RING_BYTES = 48 << 10, 112 << 10
#: columns a thread of the runtime-shape route sums (csrc/stencil_rt.cu
#: kCols): each block entry it reads from shared memory serves both
RT_COLS = 2
#: block bytes a site and direction up to which a tile of the runtime-shape
#: route takes at most 16 sites (else 32): narrow shapes ran faster in more,
#: smaller blocks (tools/kernel_variants.py)
RT_NARROW_BYTES = 64


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


def _shifter(x: CArray, offsets, packed_parity: Optional[int], KD: int, bd: int):
    """x [n, KD*BD, *lat] as [n, KD, BD, *lat], and a function of d giving
    it shifted by offsets[d] (x(s + o_d) at s; with ``packed_parity`` the
    checkerboard-packed X shift)."""
    n = x.shape[0]
    lat = tuple(x.shape[2:])
    if packed_parity is not None:
        rest = lat[1:]
        coords = np.meshgrid(*[np.arange(d) for d in rest], indexing="ij")
        m = (packed_parity + sum(coords)) % 2 == 1
        img_x_odd = torch.from_numpy(m.reshape((1, 1, 1) + tuple(rest))).to(x.device)

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

    xs4 = cplx.cmap(lambda a: a.reshape((n, KD, bd) + lat), x)
    return lambda d: cplx.cmap(lambda a: roll(a, offsets[d]), xs4)


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
    shifted = _shifter(xc, offsets, packed_parity, KD, bd)
    y = None
    for d in range(ndir):
        kr = CArray(kron.re[d], kron.im[d])
        z = cplx.cbilinear(lambda K, V: torch.einsum("ab,nbj...->naj...", K, V),
                           kr, shifted(d))
        blk = cplx.cmap(lambda a: a[d].reshape((bi, bd) + lat), blocks)
        t = cplx.cbilinear(lambda B, V: torch.einsum("ij...,naj...->nai...", B, V),
                           blk, z)
        y = t if y is None else cplx.add(y, t)
    return cplx.cmap(lambda a: a.reshape((n, KI * bi) + lat).to(x.dtype), y)


def factor_kron(kre, kim):
    """Per-direction spin-factor plan of ``kron`` [ndir, KI, KD] (numpy
    parts): the TPU kernel's ``_factor_kron``
    (``superbblas_tpu/ops/stencil_pallas.py``), copied line for line.

    Each direction is ``("direct", rows)``, or, where K_d has rank r with
    0 < r < KI and splits as K_d = R_d P_d, ``("factored", P rows, R
    rows)``: the colour product then runs on r spin slots (the Wilson hops
    r +- gamma_mu have rank 2 at r = 1).  A row lists its nonzero entries
    as (slot, re, im); entries of R that are +-1 or +-i within 1e-9 are
    snapped to them."""
    K = np.asarray(kre).astype(np.float64) + 1j * np.asarray(kim)
    ndir, KI, KD = K.shape

    def rows_of(M, tol=1e-12):
        return tuple(
            tuple((s, float(M[r, s].real), float(M[r, s].imag))
                  for s in range(M.shape[1]) if abs(M[r, s]) > tol)
            for r in range(M.shape[0]))

    specs = []
    for d in range(ndir):
        Kd = K[d]
        idx = []
        for r in range(KI):
            cand = Kd[idx + [r]]
            if np.linalg.matrix_rank(cand, tol=1e-9) > len(idx):
                idx.append(r)
        rank = len(idx)
        if 0 < rank < KI:
            P = Kd[idx]
            R = Kd @ np.linalg.pinv(P)
            R[np.abs(R) < 1e-10] = 0.0
            # snap near-integers (gamma algebra produces exact +-1/+-i)
            R = np.where(np.abs(R - np.round(R.real) - 1j * np.round(R.imag))
                         < 1e-9, np.round(R.real) + 1j * np.round(R.imag), R)
            if np.allclose(R @ P, Kd, atol=1e-10):
                specs.append(("factored", rows_of(P), rows_of(R)))
                continue
        specs.append(("direct", rows_of(Kd)))
    return tuple(specs)


def stencil_matvec_soa_planned(blocks: CArray, specs, x: CArray, offsets, bi: int,
                               bd: int, packed_parity: Optional[int] = None) -> CArray:
    """The stencil matvec with the spin factors applied from ``specs``
    (``factor_kron``'s plan): a direct direction multiplies the colour
    block into its rows' sums of x, a factored one projects x onto its r
    slots with P_d, multiplies those by the colour block, and adds R_d
    times the result, as the TPU kernel's ``_matvec_body`` and the tiled
    kernel do.  Plain PyTorch, in the promoted dtype of blocks and x (at
    least f32); the output has x's dtype."""
    cdt = torch.promote_types(torch.promote_types(blocks.dtype, x.dtype), torch.float32)
    blocks, xc = blocks.to(cdt), x.to(cdt)
    KD = x.shape[1] // bd
    KI = len(specs[0][1]) if specs[0][0] == "direct" else len(specs[0][2])
    n = x.shape[0]
    lat = tuple(x.shape[2:])
    shifted = _shifter(xc, offsets, packed_parity, KD, bd)

    def combine(row, v):
        """sum over (slot, re, im) of row of (re + i im) v[:, slot]"""
        out = None
        for sl, cr, ci in row:
            t = CArray(cr * v.re[:, sl] - ci * v.im[:, sl], cr * v.im[:, sl] + ci * v.re[:, sl])
            out = t if out is None else cplx.add(out, t)
        return out if out is not None else cplx.cmap(torch.zeros_like, CArray(v.re[:, 0],
                                                                               v.im[:, 0]))

    def colour(d, v):
        """B_d(s) v: [n, BD, *lat] -> [n, BI, *lat]"""
        blk = cplx.cmap(lambda a: a[d].reshape((bi, bd) + lat), blocks)
        return cplx.cbilinear(lambda B, V: torch.einsum("ij...,nj...->ni...", B, V), blk, v)

    y = [None] * KI
    for d, spec in enumerate(specs):
        xd = shifted(d)
        if spec[0] == "direct":
            t = [colour(d, combine(row, xd)) for row in spec[1]]
        else:
            g = [colour(d, combine(row, xd)) for row in spec[1]]
            gs = CArray(torch.stack([v.re for v in g], 1), torch.stack([v.im for v in g], 1))
            t = [combine(row, gs) for row in spec[2]]
        y = [v if acc is None else cplx.add(acc, v) for acc, v in zip(y, t)]
    return CArray(*(torch.stack(parts, 1).reshape((n, KI * bi) + lat).to(x.dtype)
                    for parts in ([v.re for v in y], [v.im for v in y])))


def _plan_dtype(a) -> np.dtype:
    """The tiled kernel's plan record (csrc/stencil_tiled.cu PlanDir) with
    values of numpy type ``a``."""
    return np.dtype([("mode", "<i4"), ("rank", "<i4"), ("slots", "<i4"), ("rslots", "<i4"),
                     ("k", a, (2, 4, 4)), ("r", a, (2, 4, 2)), ("t", a, (2, 4)),
                     ("q", a, (2, 4))])


def kernel_plan(specs, K: np.ndarray, kdt) -> Tuple[np.ndarray, bool]:
    """The tiled kernel's table of ``specs``, ``factor_kron``'s plan of
    the kron ``K`` (complex [ndir, KI, KD], KI, KD <= 4), in the sum type
    ``kdt``: one PlanDir record a direction, and whether every direction
    takes the sparse form.

    A record holds the dense coefficients (K_d itself for a direct
    direction; P_d in rows < r and R_d for a factored one of rank r <= 2)
    and, for the sparse form, four terms (slot, coefficient) and one
    (slot, coefficient) of R a row: a direct direction whose rows have at
    most one nonzero (term a is row a's), a factored one of rank <= 2
    whose P rows have at most two nonzeros (terms 2c, 2c+1 are row c's)
    and whose R rows at most one.  The sparse form scales each P row to a
    first coefficient of 1 and its R column by the inverse, so a row's
    projection is one complex multiply-add.  That is the Wilson family's
    plan (centre diagonal, hops r +- gamma_mu at r = 1); the dense form
    takes every kron.  A factored direction of rank 3 runs direct: no
    operator has one, and it would save a quarter of the colour work."""
    a = np.float64 if kdt == torch.float64 else np.float32
    rec = np.zeros(len(specs), _plan_dtype(a))
    sparse = True
    for d, spec in enumerate(specs):
        r = rec[d]
        factored = spec[0] == "factored" and len(spec[1]) <= 2
        rows = spec[1] if spec[0] == "direct" or factored else tuple(
            tuple((sl, float(K[d, i, sl].real), float(K[d, i, sl].imag))
                  for sl in range(K.shape[2]) if abs(K[d, i, sl]) > 1e-12)
            for i in range(K.shape[1]))
        r["mode"], r["rank"] = (1, len(spec[1])) if factored else (0, 0)
        per = 2 if factored else 1
        # the sparse form's scale of each P row: its first coefficient
        first = [complex(row[0][1], row[0][2]) if factored and row else 1.0 for row in rows]
        if factored:
            for i, row in enumerate(rows):
                for sl, cr, ci in row:
                    r["k"][:, i, sl] = cr, ci
            for i, row in enumerate(spec[2]):
                for c, cr, ci in row:
                    r["r"][:, i, c] = cr, ci
                if len(row) > 1:
                    sparse = False
                elif row:
                    r["rslots"] |= row[0][0] << (4 * i)
                    q = complex(row[0][1], row[0][2]) * first[row[0][0]]
                    r["q"][:, i] = q.real, q.imag
        else:
            r["k"][0, :K.shape[1], :K.shape[2]] = K[d].real
            r["k"][1, :K.shape[1], :K.shape[2]] = K[d].imag
        for i, row in enumerate(rows):
            if len(row) > per:
                sparse = False
                continue
            for e, (sl, cr, ci) in enumerate(row):
                t = 1.0 if factored and e == 0 else complex(cr, ci) / first[i]
                r["slots"] |= sl << (4 * (per * i + e))
                r["t"][:, per * i + e] = t.real, t.imag
    return rec, sparse


class _Plan:
    """The spin plan of one kron value: ``factor_kron``'s specs, the tiled
    kernel's table on a device and whether it takes the sparse form."""
    __slots__ = ("specs", "table", "sparse")


#: host values of kron tensors: (id(re), id(im)) -> [weakrefs, versions,
#: (re, im) numpy parts or None, derivation (parent CArray, fn) or None];
#: an entry leaves when its real part is freed
_HOST: dict = {}
#: plans by (kron value, sum type, device), the most recent PLAN_CACHE
_PLANS: "collections.OrderedDict" = collections.OrderedDict()
#: plans kept
PLAN_CACHE = 64


def _host_entry(kron: CArray, create: bool):
    key = (id(kron.re), id(kron.im))
    e = _HOST.get(key)
    versions = (kron.re._version, kron.im._version)
    if e is not None and e[0][0]() is kron.re and e[0][1]() is kron.im and e[1] == versions:
        return e
    if not create:
        return None
    e = [(weakref.ref(kron.re), weakref.ref(kron.im)), versions, None, None]
    _HOST[key] = e
    weakref.finalize(kron.re, _HOST.pop, key, None)
    return e


def derive_kron(parent: Optional[CArray], child: Optional[CArray], fn) -> None:
    """Record that the kron tensor ``child`` holds ``fn(re, im)`` of
    ``parent``'s numpy parts (in the tensors' own dtype, so that ``fn``
    gives the device's bits): its spin plan then comes from the parent's
    host value, with no device-to-host read.  ``adjoint_operator``,
    ``twisted_mass_operator`` and ``hopping_packed_soa`` record their
    krons so; a solve that builds its adjoint on every call reads nothing.
    No-op where either is None or not a CArray."""
    if parent is None or child is None or not (cplx.is_carray(parent)
                                               and cplx.is_carray(child)):
        return
    _host_entry(child, True)[3] = (parent, fn)


def host_kron(kron: CArray) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy (re, im) parts of ``kron``: from its derivation or the
    value kept for the tensor, else one device-to-host read (counted by
    ``stencil_matvec_soa.kron_reads``), kept while the tensors live and are
    not written."""
    e = _host_entry(kron, True)
    if e[2] is None:
        if e[3] is not None:
            parent, fn = e[3]
            e[2] = fn(*host_kron(parent))
        else:
            e[2] = (tracker.to_host(kron.re), tracker.to_host(kron.im))
            stencil_matvec_soa.kron_reads += 1
    return e[2]


def spin_plan(kron: CArray, kdt) -> _Plan:
    """The tiled kernel's plan of ``kron`` for sums in ``kdt``: built once
    per kron value, device and sum type (``factor_kron`` and the table's
    upload, counted by ``stencil_matvec_soa.plan_builds``), from the
    kron's host value (``host_kron``)."""
    kre, kim = host_kron(kron)
    key = (kre.dtype.str, kre.shape, kre.tobytes(), kim.tobytes(), kdt, str(kron.re.device))
    p = _PLANS.get(key)
    if p is not None:
        _PLANS.move_to_end(key)
        return p
    p = _Plan()
    p.specs = factor_kron(kre, kim)
    p.table, p.sparse = None, False
    if kre.shape[1] <= 4 and kre.shape[2] <= 4:
        rec, p.sparse = kernel_plan(p.specs, kre.astype(np.float64) + 1j * kim, kdt)
        p.table = torch.from_numpy(rec.view(np.uint8).copy()).to(kron.re.device)
    _PLANS[key] = p
    if len(_PLANS) > PLAN_CACHE:
        _PLANS.popitem(last=False)
    stencil_matvec_soa.plan_builds += 1
    return p


def clear_plans() -> None:
    """Drop every kept plan: the next launch on each kron value builds its
    plan again (so a run can count the plans one solve builds).  Host
    values stay."""
    _PLANS.clear()


def x_chunk(Y: int, Z: int, T: int, site_bytes: int) -> int:
    """Y rows the tiled kernel's blocks cover at one x before they step X:
    the largest divisor of Y whose rows (``site_bytes`` of traffic a site)
    fit in L2_REUSE_BYTES, so a block's X neighbours are still in L2 when
    their own blocks run; at least 1."""
    for yc in range(Y, 0, -1):
        if Y % yc == 0 and yc * Z * T * site_bytes <= L2_REUSE_BYTES:
            return yc
    return 1


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


def k1_route(shape: Sequence[int], storage, field, volume: int,
             ptrs: Sequence[int] = ()) -> str:
    """The route of K1 for (KI, KD, BI, BD) ``shape``, (storage, field)
    dtypes, ``volume`` sites and the blocks' data pointers ``ptrs``:
    "tiled" at TILED_SHAPES; at SITE_SHAPE "site16" (the block-streaming
    kernel with 16-byte copies: volume x element size a multiple of 16
    bytes and every pointer 16-byte aligned), "site" (the same kernel with
    element copies) at the other f32-summed pairs and "templated" at
    f64/f64; "runtime" at every other shape.  The keys of
    ``stencil_matvec_soa.by_route``."""
    shape = tuple(shape)
    if shape in TILED_SHAPES:
        return "tiled"
    if shape != SITE_SHAPE:
        return "runtime"
    if storage == torch.float64 or field == torch.float64:
        return "templated"
    aligned = volume * storage.itemsize % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    return "site16" if aligned else "site"


def check_block(KI: int, KD: int, bi: int, bd: int) -> None:
    """Raise ValueError above the MAX_BLOCK rule, on every device."""
    if min(KI, KD, bi, bd) < 1 or KI * KD * bi * bd > MAX_BLOCK:
        raise ValueError(f"(KI, KD, BI, BD) = {(KI, KD, bi, bd)}: the SoA stencil takes "
                         f"positive extents with KI*KD*BI*BD <= {MAX_BLOCK}")


def check_kernel_case(blocks: CArray, kron: Optional[CArray], x: CArray,
                      offsets, bi: int, bd: int,
                      packed_parity: Optional[int] = None) -> Tuple[int, int]:
    """Raise unless the CUDA stencil kernels take these operands (device
    aside): any shape within MAX_BLOCK, every pair of KERNEL_DTYPES;
    returns (KI, KD)."""
    if packed_parity not in (None, 0, 1):
        raise ValueError(f"packed_parity={packed_parity!r}: a checkerboard parity is "
                         "None, 0 or 1")
    ndir = blocks.shape[0]
    KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
    check_block(KI, KD, bi, bd)
    if (blocks.dtype, x.dtype) not in KERNEL_DTYPES:
        raise ValueError(f"storage/field dtypes {blocks.dtype}/{x.dtype}: the CUDA "
                         f"stencil kernel takes {KERNEL_DTYPES}")
    if not _offsets_ok(_offsets_key(offsets), tuple(blocks.shape[2:])) \
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
    if n < 1 or n > 2 ** 31 - 1 or any(v > 2 ** 31 - 1 for v in lat):
        raise ValueError(f"{n} columns on lattice {lat}: outside the kernels' 32-bit "
                         "extents")
    return KI, KD


def check_32bit(KI: int, KD: int, bi: int, bd: int, x: CArray, what: str) -> None:
    """Raise ValueError where one column's field or one direction's blocks
    pass TILED_MAX_VALUES values: the tiled kernel and the schedules index
    them in 32 bits."""
    per_site = max(KD * bd, KI * bi, bi * bd)
    if per_site * x.shape[2:].numel() > TILED_MAX_VALUES:
        raise ValueError(f"lattice {tuple(x.shape[2:])}: the {what} indexes one column's "
                         f"field and one direction's blocks in 32 bits, at most "
                         f"{TILED_MAX_VALUES} values ({per_site} a site)")


@functools.lru_cache(maxsize=256)
def _offsets_ok(offsets: Tuple[Tuple[int, ...], ...], lat: Tuple[int, ...]) -> bool:
    """``soa_eligible`` of these offsets on this lattice, kept per value (a
    launch checks it on the host every call)."""
    return soa_eligible(offsets, lat)


def _row_stride(slots: int, itemsize: int) -> int:
    """Elements from one row of a schedule's tile to the next in shared
    memory: ``slots`` rounded up to whole 16-byte units."""
    vec = 16 // itemsize
    return -(-slots // vec) * vec


def xin_tile(n: int, X: int, F: int, itemsize: int) -> Tuple[int, int, int]:
    """(S, C, rs) of the X-inside kernel: a tile of S consecutive sites of
    an X plane whose whole X lines (X x F features x 2 parts of
    ``itemsize`` bytes a site) of one group of C columns fill one of two
    stages of XIN_STAGE_BYTES, rows ``rs`` elements apart.  S first, a
    power of two up to 32 (the sites of a plane one warp reads), then C, a
    power of two up to 8 and half of n (so that a block walks two groups
    or more, one loading while the other sums).  Where one line passes a
    stage but two fit in a block's shared memory the tile is one site of
    one column; where they do not, ValueError, as the TPU wrapper raises
    where no (nc, Yc) fits its VMEM."""
    line = X * F * 2 * itemsize
    pairs = XIN_STAGE_BYTES // line
    if pairs < 1:
        if 2 * line > SMEM_BYTES:
            raise ValueError(
                f"no tile of the X-inside stencil kernel fits in shared memory: one X "
                f"line of {X} sites x {F} features takes {line} B, and two stages of it "
                f"pass a block's {SMEM_BYTES} B")
        return 1, 1, _row_stride(1, itemsize)
    S = 1
    while S < 32 and 2 * S <= pairs:
        S *= 2
    C = 1
    while C < 8 and 2 * C <= -(-n // 2) and 2 * C * S <= pairs:
        C *= 2
    return S, C, _row_stride(S, itemsize)


def stream_tile(n: int, rows: int, T: int, F: int, itemsize: int,
                nc: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(S, R, C, rs) of the X-streaming kernel: a tile of R rows (y, z) of
    S T-sites and C columns (``nc``, or the largest of 4, 2, 1 that divides
    n, as the TPU wrapper picks its nc), each row widened by a T halo of
    one site a side, rows ``rs`` = S + 16 bytes apart (a row's right halo
    takes the next row's first slot), whose ring of four planes fits
    STREAM_RING_BYTES.  S starts at the power of two that covers T, at
    most 32, R at STREAM_THREADS sums a plane; R and then S halve until the
    ring fits.  ValueError where one site of C columns does not."""
    vec = 16 // itemsize
    C = nc if nc is not None else next(c for c in (4, 2, 1) if n % c == 0)
    S = min(32, 1 << (T - 1).bit_length())

    def ring(S, R):
        return 4 * (2 * F * R * C * _row_stride(S + vec, itemsize) + vec) * itemsize

    while True:
        R = max(1, min(rows, STREAM_THREADS // (S * C)))
        while R > 1 and ring(S, R) > STREAM_RING_BYTES:
            R //= 2
        if ring(S, R) <= STREAM_RING_BYTES:
            return S, R, C, _row_stride(S + vec, itemsize)
        if S == 1:
            raise ValueError(
                f"no tile of the X-streaming stencil kernel fits in shared memory: a ring "
                f"of four planes of one site x {C} columns x {F} features takes "
                f"{ring(1, 1)} B, more than {STREAM_RING_BYTES}")
        S //= 2


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def rt_dir_bytes(KI: int, KD: int, BI: int, BD: int, S: int, C: int, storage_size: int,
                 field_size: int) -> int:
    """Shared memory of one direction's slot of a stage of the runtime-shape
    route: a tile's block planes [2, BI*BD, S], then its columns' neighbour
    features [2, C, KD*BD, S + 16 bytes] (a row's halo sites), columns
    padded where S < 32 so that a warp's sets of RT_COLS columns lie S
    sites apart in the banks, and 16 bytes for the last row's halo, each
    part in whole 16 bytes (csrc/stencil_rt.cu ``layout``)."""
    vec = 16 // field_size
    xcs = KD * BD * (S + vec)
    if S < 32 and S // RT_COLS % vec == 0:
        xcs += (S // RT_COLS - xcs) % (128 // field_size // RT_COLS)
    return _round16(2 * BI * BD * S * storage_size) + \
        _round16((2 * C * xcs + vec) * field_size)


def rt_smem(KI: int, KD: int, BI: int, BD: int, ndir: int, S: int, C: int, D: int,
            stages: int, storage_size: int, field_size: int) -> int:
    """Shared memory of one block of the runtime-shape route: the kron
    factors [2, ndir, KI, KD] in the sum type (f64 for f64 fields, else
    f32), then ``stages`` stages of D direction slots (``rt_dir_bytes``)."""
    acc = 8 if field_size == 8 else 4
    return _round16(2 * ndir * KI * KD * acc) + stages * D * rt_dir_bytes(
        KI, KD, BI, BD, S, C, storage_size, field_size)


#: most threads a (site, column) of the runtime-shape route's rowwise split
#: (csrc/stencil_rt.cu kRowThreads)
RT_ROW_THREADS = 32


def rt_split(KI: int, BI: int) -> Tuple[int, int]:
    """(R, G) of the runtime-shape route: a thread owns up to R outputs of
    one (site, column), R = BI for BI <= 4 (no idle slot), else 8, within
    one row a of K_d (G = KI * ceil(BI / R) threads a (site, column));
    where that passes RT_ROW_THREADS, R = 8 (16 above 128 outputs)
    consecutive outputs across rows (G = ceil(KI*BI / R) <= 16)."""
    R = BI if BI <= 4 else 8
    G = KI * -(-BI // R)
    if G <= RT_ROW_THREADS:
        return R, G
    R = 8 if KI * BI <= 128 else 16
    return R, -(-KI * BI // R)


@functools.lru_cache(maxsize=256)
def rt_tile(KI: int, KD: int, BI: int, BD: int, n: int, ndir: int, storage_size: int,
            field_size: int) -> Tuple[int, int, int, int, int, int]:
    """(S, C, R, G, D, stages) of the runtime-shape route.  A tile of S
    consecutive sites (a power of two) and C columns; a thread sums RT_COLS
    columns of a site, and G threads share a (site, column set), each
    owning up to R of its outputs (``rt_split``); ``rt_threads`` threads a
    block, at most RT_THREADS.  C is up to 8 columns (the block
    planes a stage holds serve them all), then S the largest power of two
    from 8 to 32 (16 at the narrow shapes, RT_NARROW_BYTES) that the threads
    allow (64 sites ran slower).  A stage
    holds D of the ndir directions, as many as fit RT_STAGE_BYTES (the
    narrow shapes do little work a direction: their copies are in flight
    longer than they take to sum), spread evenly over the stages of a unit;
    the ring holds as many stages (2 to RT_MAX_STAGES) as fit
    RT_RING_BYTES; both targets scale with the block's share of
    RT_THREADS.  S, then C, halve until two stages of one direction fit a
    block's SMEM_BYTES.  At 8 columns and 9 directions, f32: (2, 2, 3, 3)
    16 sites x 8 columns, two threads a (site, column set) (R = 3), 2
    directions a stage, three stages; (1, 1, 2, 2) 16 x 8, 3 directions a
    stage, three stages; (2, 2, 8, 8) and (1, 1, 16, 16) 32 x 8, two threads a (site,
    column set), one direction a stage, two stages."""
    R, G = rt_split(KI, BI)
    C = max(1, min(n, 8, RT_COLS * (RT_THREADS // (8 * G))))
    sets = -(-C // RT_COLS)
    S, S_max = 8, 16 if BI * BD * storage_size <= RT_NARROW_BYTES else 32
    while S < S_max and 2 * S * sets * G <= RT_THREADS:
        S *= 2

    def smem(S, C, D, stages):
        return rt_smem(KI, KD, BI, BD, ndir, S, C, D, stages, storage_size, field_size)

    while smem(S, C, 1, 2) > SMEM_BYTES:
        if S > 8:
            S //= 2
        elif C > 1:
            C //= 2
        else:
            raise ValueError(f"no tile of the runtime-shape stencil kernel fits in shared "
                             f"memory at {(KI, KD, BI, BD)} with {ndir} directions")
    one = rt_dir_bytes(KI, KD, BI, BD, S, C, storage_size, field_size)
    share = rt_threads(S, C, G) / RT_THREADS   # the targets scale with the threads
    steps = -(-ndir // max(1, min(ndir, int(RT_STAGE_BYTES * share) // one)))
    D = -(-ndir // steps)
    stages = max(2, min(RT_MAX_STAGES, int(RT_RING_BYTES * share) // (D * one)))
    while stages > 2 and smem(S, C, D, stages) > SMEM_BYTES:
        stages -= 1
    while smem(S, C, D, stages) > SMEM_BYTES:
        D -= 1
    return S, C, R, G, D, stages


def rt_threads(S: int, C: int, G: int) -> int:
    """Threads a block of the runtime-shape route: S sites x the group's
    sets of RT_COLS columns x G threads a (site, column set)."""
    return S * -(-C // RT_COLS) * G


@functools.lru_cache(maxsize=64)
def _offsets_array(offsets: Tuple[Tuple[int, ...], ...]):
    """The C entries' offsets argument, [ndir, 4] ints, one per offsets."""
    flat = [int(v) for off in offsets for v in off]
    return (ctypes.c_int * len(flat))(*flat)


def _offsets_key(offsets) -> Tuple[Tuple[int, ...], ...]:
    if isinstance(offsets, (tuple, list)) and all(type(o) is tuple for o in offsets):
        return tuple(offsets)
    return tuple(tuple(int(v) for v in off) for off in offsets)


def _sum_dtype(x: CArray):
    """The type the kernels sum in, and take their kron factors in."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _kron_ptrs(kron: Optional[CArray]) -> tuple:
    """The kron arguments of the C entries but the tiled one."""
    return (None, None) if kron is None else (kron.re.data_ptr(), kron.im.data_ptr())


def _launch(entry: str, blocks, kptrs: tuple, x, offsets, bi, bd, KI, KD, *extra) -> CArray:
    """Run C entry ``entry`` on the operands with its kron or plan
    arguments ``kptrs``; returns y."""
    from . import _cuda

    dev = x.device
    if blocks.re.device != dev or blocks.im.device != dev:
        raise ValueError(f"operands on {blocks.re.device}/{blocks.im.device} and {dev}")
    n = x.shape[0]
    lat = tuple(x.shape[2:])
    y = CArray(x.re.new_empty((n, KI * bi) + lat), x.re.new_empty((n, KI * bi) + lat))
    key = _offsets_key(offsets)
    with _cuda.on_device(dev):
        err = getattr(_cuda.library(), entry)(
            KI, KD, bi, bd, KERNEL_DTYPES.index((blocks.dtype, x.dtype)),
            blocks.re.data_ptr(), blocks.im.data_ptr(), *kptrs,
            x.re.data_ptr(), x.im.data_ptr(), y.re.data_ptr(), y.im.data_ptr(),
            n, *lat, len(key), _offsets_array(key), *extra,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return y


def _kron_for(kron: Optional[CArray], x: CArray) -> Optional[CArray]:
    """``kron`` in the sum type of x's kernels but the tiled one (a no-op
    where it is that type already); None stays None; raises on another
    device."""
    if kron is None:
        return None
    if kron.re.device != x.device or kron.im.device != x.device:
        raise ValueError(f"operands on {kron.re.device}/{kron.im.device} and {x.device}")
    kdt = _sum_dtype(x)
    return cplx.cmap(lambda v: v.to(kdt).contiguous(), kron)


def tiled_site_bytes(blocks: CArray, x: CArray, KI: int, bi: int) -> int:
    """Device-memory traffic of one site in the tiled kernel: its blocks,
    x read and y written, every column."""
    ndir, nb = blocks.shape[0], blocks.shape[1]
    return 2 * (ndir * nb * blocks.re.element_size()
                + x.shape[0] * (x.shape[1] + KI * bi) * x.re.element_size())


def _on_cpu(blocks: CArray, x: CArray, name: str) -> bool:
    """True for CPU operands (the plain version's case), False for CUDA
    ones; raises for any other device."""
    if x.re.device.type == "cpu" and blocks.re.device.type == "cpu":
        return True
    if x.re.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.re.device}")
    return False


@tracker.spanned("k1", events=False)
def stencil_matvec_soa(blocks: CArray, kron: Optional[CArray], x: CArray,
                       offsets: Sequence[Tuple[int, ...]], bi: int, bd: int,
                       interpret: bool = False, packed_parity: Optional[int] = None,
                       chunks: Optional[Tuple[int, int]] = None) -> CArray:
    """y[n, KI*BI, X, Y, Z, T] = SoA stencil matvec; with ``packed_parity``
    (0 or 1) the operands hold one checkerboard parity with X halved.
    ``interpret`` and ``chunks`` (the TPU kernel's interpreter switch and
    its (nc, Yc) VMEM chunks) are accepted and unused; ``chunks`` that do
    not divide (n, Y) raise the JAX package's ValueError.

    CPU operands run the plain version.  CUDA operands run the kernel:
    the tiled kernel with the kron's spin plan at TILED_SHAPES, the
    block-streaming one (f64: the templated one) at SITE_SHAPE
    (``stencil_matvec_soa.launches`` counts the launches of these routes,
    ``.by_shape`` them by shape, ``.by_route`` by ``k1_route``'s name),
    :func:`stencil_matvec_soa_rt` at the other shapes; a case none takes
    raises.  Above MAX_BLOCK it raises ValueError on every device.  Each
    call is a ``k1`` span of the tracker (host time, entry to return)."""
    refuse_dtensor("stencil_matvec_soa", "parallel.apply_stencil_soa_sharded",
                   tuple(blocks), tuple(x))
    KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
    check_block(KI, KD, bi, bd)
    if chunks is not None:
        nc, Yc = chunks
        if x.shape[0] % nc or blocks.shape[3] % Yc:
            raise ValueError(f"chunks {chunks} must divide (n={x.shape[0]}, "
                             f"Y={blocks.shape[3]})")
    if torch.compiler.is_compiling():
        kre, kim = (None, None) if kron is None else (kron.re, kron.im)
        return CArray(*torch.ops.sbt.stencil_matvec_soa(
            blocks.re, blocks.im, kre, kim, x.re, x.im,
            [int(v) for off in offsets for v in off], bi, bd,
            -1 if packed_parity is None else int(packed_parity)))
    if _on_cpu(blocks, x, "stencil_matvec_soa"):
        return stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd,
                                            packed_parity=packed_parity)
    if (KI, KD, bi, bd) not in KERNEL_SHAPES:
        return stencil_matvec_soa_rt(blocks, kron, x, offsets, bi, bd,
                                     packed_parity=packed_parity)
    if (KI, KD, bi, bd) in TILED_SHAPES:
        check_32bit(KI, KD, bi, bd, x, "tiled stencil kernel")
    check_kernel_case(blocks, kron, x, offsets, bi, bd, packed_parity)
    parity = -1 if packed_parity is None else int(packed_parity)
    route = k1_route((KI, KD, bi, bd), blocks.dtype, x.dtype, x.shape[2:].numel(),
                     (blocks.re.data_ptr(), blocks.im.data_ptr()))
    if route == "tiled":
        X, Y, Z, T = x.shape[2:]
        if kron is not None and (kron.re.device != x.device or kron.im.device != x.device):
            raise ValueError(f"operands on {kron.re.device}/{kron.im.device} and {x.device}")
        p = None if kron is None else spin_plan(kron, _sum_dtype(x))
        table, sparse = (None, 0) if p is None else (p.table.data_ptr(), int(p.sparse))
        yc = x_chunk(Y, Z, T, tiled_site_bytes(blocks, x, KI, bi))
        y = _launch("sbt_stencil_tiled", blocks, (table,), x, offsets, bi, bd, KI, KD,
                    parity, sparse, yc)
    elif route == "templated":
        y = _launch("sbt_stencil_soa", blocks, _kron_ptrs(_kron_for(kron, x)), x, offsets,
                    bi, bd, KI, KD, parity)
    else:
        y = _launch("sbt_stencil_site", blocks, _kron_ptrs(_kron_for(kron, x)), x, offsets,
                    bi, bd, KI, KD, parity, int(route == "site16"))
    stencil_matvec_soa.launches += 1
    stencil_matvec_soa.by_shape[KI, KD, bi, bd] += 1
    stencil_matvec_soa.by_route[route] += 1
    return y


@torch.library.custom_op("sbt::stencil_matvec_soa", mutates_args=())
def _stencil_op(blocks_re: torch.Tensor, blocks_im: torch.Tensor,
                kron_re: Optional[torch.Tensor], kron_im: Optional[torch.Tensor],
                x_re: torch.Tensor, x_im: torch.Tensor, offsets: List[int], bi: int,
                bd: int, packed_parity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`stencil_matvec_soa` as an op of a traced program: the
    offsets flattened, packed_parity -1 for None; the outputs contiguous,
    as the fake implementation says (the kernel's are; the plain
    version's may not be)."""
    nd = x_re.ndim - 2
    offs = tuple(tuple(offsets[i:i + nd]) for i in range(0, len(offsets), nd))
    kron = None if kron_re is None else CArray(kron_re, kron_im)
    y = stencil_matvec_soa(CArray(blocks_re, blocks_im), kron, CArray(x_re, x_im), offs,
                           bi, bd, packed_parity=None if packed_parity < 0 else packed_parity)
    return y.re.contiguous(), y.im.contiguous()


@_stencil_op.register_fake
def _(blocks_re, blocks_im, kron_re, kron_im, x_re, x_im, offsets, bi, bd, packed_parity):
    KI = 1 if kron_re is None else kron_re.shape[1]
    shape = (x_re.shape[0], KI * bi) + tuple(x_re.shape[2:])
    return x_re.new_empty(shape), x_im.new_empty(shape)


def stencil_matvec_soa_rt(blocks: CArray, kron: Optional[CArray], x: CArray,
                          offsets: Sequence[Tuple[int, ...]], bi: int, bd: int,
                          packed_parity: Optional[int] = None) -> CArray:
    """K1's runtime-shape route (same contract as
    :func:`stencil_matvec_soa`, any shape with KI*KD*BI*BD <= MAX_BLOCK,
    the column counts ``check_kernel_case`` takes, lattices up to
    TILED_MAX_VALUES values a column's field or a direction's blocks):
    ``stencil_matvec_soa`` sends the shapes outside KERNEL_SHAPES here, at
    the tile ``rt_tile`` picks (csrc/stencil_rt.cu).  It gives the
    schedules' bits at every shape, the templated and block-streaming
    routes' at (1, 1, 12, 12) and the tiled route's where no direction of
    its spin plan factors.  CPU operands run the plain version; CUDA
    operands the kernel (``stencil_matvec_soa_rt.launches``) or raise."""
    refuse_dtensor("stencil_matvec_soa_rt", "parallel.apply_stencil_soa_sharded",
                   tuple(blocks), tuple(x))
    if torch.compiler.is_compiling():
        return _traced("stencil_matvec_soa_rt", blocks, kron, x, offsets, bi, bd,
                       -1 if packed_parity is None else int(packed_parity))
    if _on_cpu(blocks, x, "stencil_matvec_soa_rt"):
        KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
        check_block(KI, KD, bi, bd)
        return stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd,
                                            packed_parity=packed_parity)
    KI, KD = check_kernel_case(blocks, kron, x, offsets, bi, bd, packed_parity)
    check_32bit(KI, KD, bi, bd, x, "runtime-shape stencil kernel")
    S, C, R, _, D, stages = rt_tile(KI, KD, bi, bd, x.shape[0], len(offsets),
                                    blocks.re.element_size(), x.re.element_size())
    y = _launch("sbt_stencil_soa_rt", blocks, _kron_ptrs(_kron_for(kron, x)), x, offsets,
                bi, bd, KI, KD,
                -1 if packed_parity is None else int(packed_parity), S, C, R, D, stages)
    stencil_matvec_soa_rt.launches += 1
    stencil_matvec_soa_rt.by_shape[KI, KD, bi, bd] += 1
    return y


def _traced(name: str, blocks: CArray, kron: Optional[CArray], x: CArray, offsets, bi: int,
            bd: int, *extra) -> CArray:
    """Entry ``name`` as its custom op ``sbt::<name>`` in a traced program
    (the offsets flattened; ``extra`` the entry's own int argument)."""
    kre, kim = (None, None) if kron is None else (kron.re, kron.im)
    return CArray(*getattr(torch.ops.sbt, name)(
        blocks.re, blocks.im, kre, kim, x.re, x.im,
        [int(v) for off in offsets for v in off], bi, bd, *extra))


def _untraced(x_re: torch.Tensor, blocks_re, blocks_im, kron_re, kron_im, x_im, offsets):
    """The CArrays and offsets of a custom op's arguments."""
    nd = x_re.ndim - 2
    offs = tuple(tuple(offsets[i:i + nd]) for i in range(0, len(offsets), nd))
    kron = None if kron_re is None else CArray(kron_re, kron_im)
    return CArray(blocks_re, blocks_im), kron, CArray(x_re, x_im), offs


def _fake_y(kron_re, x_re, x_im, bi):
    KI = 1 if kron_re is None else kron_re.shape[1]
    shape = (x_re.shape[0], KI * bi) + tuple(x_re.shape[2:])
    return x_re.new_empty(shape), x_im.new_empty(shape)


@torch.library.custom_op("sbt::stencil_matvec_soa_rt", mutates_args=())
def _rt_op(blocks_re: torch.Tensor, blocks_im: torch.Tensor,
           kron_re: Optional[torch.Tensor], kron_im: Optional[torch.Tensor],
           x_re: torch.Tensor, x_im: torch.Tensor, offsets: List[int], bi: int, bd: int,
           packed_parity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`stencil_matvec_soa_rt` as an op of a traced program."""
    b, k, x, offs = _untraced(x_re, blocks_re, blocks_im, kron_re, kron_im, x_im, offsets)
    y = stencil_matvec_soa_rt(b, k, x, offs, bi, bd,
                              packed_parity=None if packed_parity < 0 else packed_parity)
    return y.re.contiguous(), y.im.contiguous()


@torch.library.custom_op("sbt::stencil_matvec_soa_xin", mutates_args=())
def _xin_op(blocks_re: torch.Tensor, blocks_im: torch.Tensor,
            kron_re: Optional[torch.Tensor], kron_im: Optional[torch.Tensor],
            x_re: torch.Tensor, x_im: torch.Tensor, offsets: List[int], bi: int,
            bd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`stencil_matvec_soa_xin` as an op of a traced program: the
    kron's spin plan is built from its value when the program runs."""
    b, k, x, offs = _untraced(x_re, blocks_re, blocks_im, kron_re, kron_im, x_im, offsets)
    y = stencil_matvec_soa_xin(b, k, x, offs, bi, bd)
    return y.re.contiguous(), y.im.contiguous()


@torch.library.custom_op("sbt::stencil_matvec_soa_stream", mutates_args=())
def _stream_op(blocks_re: torch.Tensor, blocks_im: torch.Tensor,
               kron_re: Optional[torch.Tensor], kron_im: Optional[torch.Tensor],
               x_re: torch.Tensor, x_im: torch.Tensor, offsets: List[int], bi: int,
               bd: int, nc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`stencil_matvec_soa_stream` as an op of a traced program (nc
    -1 for None); the kron's spin plan as for the X-inside schedule."""
    b, k, x, offs = _untraced(x_re, blocks_re, blocks_im, kron_re, kron_im, x_im, offsets)
    y = stencil_matvec_soa_stream(b, k, x, offs, bi, bd, nc=None if nc < 0 else nc)
    return y.re.contiguous(), y.im.contiguous()


@_rt_op.register_fake
def _(blocks_re, blocks_im, kron_re, kron_im, x_re, x_im, offsets, bi, bd, packed_parity):
    return _fake_y(kron_re, x_re, x_im, bi)


@_xin_op.register_fake
def _(blocks_re, blocks_im, kron_re, kron_im, x_re, x_im, offsets, bi, bd):
    return _fake_y(kron_re, x_re, x_im, bi)


@_stream_op.register_fake
def _(blocks_re, blocks_im, kron_re, kron_im, x_re, x_im, offsets, bi, bd, nc):
    return _fake_y(kron_re, x_re, x_im, bi)


def _schedule(entry: str, blocks: CArray, kron: Optional[CArray], x: CArray, offsets,
              bi: int, bd: int, KI: int, KD: int, tile: Tuple[int, ...],
              fits16: bool) -> CArray:
    """Launch schedule ``entry`` (sbt_stencil_soa_xin or _stream) with the
    ``tile`` its picker chose: the kron's spin plan at TILED_SHAPES, the
    kron itself elsewhere; 16-byte copies where the tile takes them
    (``fits16``) and x's parts are 16-byte aligned."""
    check_kernel_case(blocks, kron, x, offsets, bi, bd)
    check_32bit(KI, KD, bi, bd, x, "stencil schedule")
    if (KI, KD, bi, bd) in TILED_SHAPES:
        if kron is not None and (kron.re.device != x.device or kron.im.device != x.device):
            raise ValueError(f"operands on {kron.re.device}/{kron.im.device} and {x.device}")
        p = None if kron is None else spin_plan(kron, _sum_dtype(x))
        kptrs = (None if p is None else p.table.data_ptr(), None, None)
        sparse = 0 if p is None else int(p.sparse)
    else:
        kron_k = _kron_for(kron, x)
        kptrs = (None,) + _kron_ptrs(kron_k)
        sparse = 0
    wide = fits16 and x.re.data_ptr() % 16 == 0 and x.im.data_ptr() % 16 == 0
    return _launch(entry, blocks, kptrs, x, offsets, bi, bd, KI, KD, sparse, *tile, int(wide))


def stencil_matvec_soa_xin(blocks: CArray, kron: Optional[CArray], x: CArray,
                           offsets: Sequence[Tuple[int, ...]], bi: int,
                           bd: int, interpret: bool = False) -> CArray:
    """X-inside schedule of :func:`stencil_matvec_soa` (same contract, no
    packed parity, every shape and pair K1 takes, K1's bits): each block
    holds its tile's whole X lines of one column group in shared memory.
    Raises ValueError where no tile fits (``xin_tile``), on every device.
    CPU operands run the plain version; CUDA operands the kernel
    (``stencil_matvec_soa_xin.launches``) or raise.  ``interpret`` is
    accepted and unused."""
    refuse_dtensor("stencil_matvec_soa_xin", "parallel.apply_stencil_soa_sharded",
                   tuple(blocks), tuple(x))
    KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
    n, X = x.shape[0], x.shape[2]
    elem = x.re.element_size()
    S, C, rs = xin_tile(n, X, KD * bd, elem)
    if torch.compiler.is_compiling():
        return _traced("stencil_matvec_soa_xin", blocks, kron, x, offsets, bi, bd)
    if _on_cpu(blocks, x, "stencil_matvec_soa_xin"):
        return stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd)
    fits16 = S * elem % 16 == 0 and x.shape[3:].numel() * elem % 16 == 0
    y = _schedule("sbt_stencil_soa_xin", blocks, kron, x, offsets, bi, bd, KI, KD,
                  (S, C, rs), fits16)
    stencil_matvec_soa_xin.launches += 1
    return y


def stencil_matvec_soa_stream(blocks: CArray, kron: Optional[CArray], x: CArray,
                              offsets: Sequence[Tuple[int, ...]], bi: int,
                              bd: int, interpret: bool = False,
                              nc: Optional[int] = None) -> CArray:
    """X-streaming schedule of :func:`stencil_matvec_soa` (same contract,
    no packed parity, every shape and pair K1 takes, K1's bits): each block
    walks X with a ring of X planes of its tile in shared memory.  ``nc``:
    the columns of a block (``stream_tile``), a divisor of n, else
    ValueError on every device, as the TPU wrapper.  CPU operands run the
    plain version; CUDA operands the kernel
    (``stencil_matvec_soa_stream.launches``) or raise.  ``interpret`` is
    accepted and unused."""
    refuse_dtensor("stencil_matvec_soa_stream", "parallel.apply_stencil_soa_sharded",
                   tuple(blocks), tuple(x))
    n = x.shape[0]
    if nc is not None and (nc < 1 or n % nc):
        raise ValueError(f"nc={nc} must divide the column count n={n}")
    if torch.compiler.is_compiling():
        return _traced("stencil_matvec_soa_stream", blocks, kron, x, offsets, bi, bd,
                       -1 if nc is None else int(nc))
    if _on_cpu(blocks, x, "stencil_matvec_soa_stream"):
        return stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd)
    KI, KD = (1, 1) if kron is None else (kron.shape[1], kron.shape[2])
    _, Y, Z, T = x.shape[2:]
    elem = x.re.element_size()
    tile = stream_tile(n, Y * Z, T, KD * bd, elem, nc)
    vec = 16 // elem
    y = _schedule("sbt_stencil_soa_stream", blocks, kron, x, offsets, bi, bd, KI, KD, tile,
                  T % vec == 0 and tile[0] % vec == 0)
    stencil_matvec_soa_stream.launches += 1
    return y


def schedule_attrs(schedule: str, shape: Sequence[int], storage, field, n: int,
                   lat: Sequence[int], sparse: bool = True, nc: Optional[int] = None
                   ) -> list:
    """[registers, local bytes, threads, blocks an SM] of the kernel that
    ``schedule`` ("xin" or "stream") launches on n columns of lattice
    ``lat`` at (KI, KD, BI, BD) ``shape`` and the (storage, field) dtypes,
    from cudaFuncGetAttributes and the occupancy at the tile's shared
    memory."""
    from . import _cuda

    ki, kd, bi, bd = shape
    X, Y, Z, T = lat
    elem = torch.empty((), dtype=field).element_size()
    if schedule == "xin":
        S, C, rs = xin_tile(n, X, kd * bd, elem)
        R = 1
    else:
        S, R, C, rs = stream_tile(n, Y * Z, T, kd * bd, elem, nc)
    out = (ctypes.c_int * 4)()
    err = _cuda.library().sbt_stencil_schedule_attrs(
        int(schedule == "stream"), ki, kd, bi, bd, KERNEL_DTYPES.index((storage, field)),
        int(sparse), n, X, S, R, C, rs, out)
    if err != 0:
        raise RuntimeError(f"schedule attributes: cudaError {err}")
    return list(out)


def rt_attrs(shape: Sequence[int], storage, field, n: int, ndir: int) -> list:
    """[registers, local bytes, threads, blocks an SM] of the runtime-shape
    route's kernel on n columns and ndir directions at (KI, KD, BI, BD)
    ``shape`` and the (storage, field) dtypes, at ``rt_tile``'s tile, from
    cudaFuncGetAttributes and the occupancy at its shared memory."""
    from . import _cuda

    ki, kd, bi, bd = shape
    S, C, R, _, D, stages = rt_tile(ki, kd, bi, bd, n, ndir, storage.itemsize, field.itemsize)
    out = (ctypes.c_int * 4)()
    err = _cuda.library().sbt_stencil_soa_rt_attrs(
        ki, kd, bi, bd, KERNEL_DTYPES.index((storage, field)), ndir, S, C, R, D, stages, out)
    if err != 0:
        raise RuntimeError(f"runtime-shape route attributes: cudaError {err}")
    return list(out)


#: launches of each route, and of each route by (KI, KD, BI, BD) and, for
#: ``stencil_matvec_soa``, by ``k1_route``'s name; the tiled route's spin
#: plans built (``spin_plan``) and kron tensors read to the host for them
#: (``host_kron``)
stencil_matvec_soa.launches = 0
stencil_matvec_soa.by_shape = collections.Counter()
stencil_matvec_soa.by_route = collections.Counter()
stencil_matvec_soa.plan_builds = 0
stencil_matvec_soa.kron_reads = 0
stencil_matvec_soa_rt.launches = 0
stencil_matvec_soa_rt.by_shape = collections.Counter()
stencil_matvec_soa_xin.launches = 0
stencil_matvec_soa_stream.launches = 0
