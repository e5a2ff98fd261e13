"""The s5 terms of the SoA domain-wall apply (``models/domain_wall.py``)
in one pass over split-complex f32 or f64 fields [n, Ls, 12, *lat]
(``csrc/dw_s5.cu``).  With H v|_s = hp_s v_{s+1} + hm_s v_{s-1}, hp_s =
lam+_s wp, hm_s = lam-_s wm (per-channel weights ``wp``, ``wm`` [12];
lam+ = ``wall`` at s = Ls-1 and lam- = ``wall`` at s = 0, ``bulk``
elsewhere), a pass is one of

    "right_pre"   b5 x + c5 H x          Moebius right, before K1
    "right_post"  y + x - H x            Moebius right, after K1 (y = D_W z)
    "left"        b5 y + x + H(c5 y - x) Moebius left, after K1 (y = D_W x)
    "shamir"      y + H x                Shamir, after K1 (y = D_W x)

``dw_s5`` takes CPU tensors to the plain version and CUDA tensors to the
kernel (planes made contiguous, weights cast to the planes' dtype; the
16-byte form where the sites a plane are a multiple of the sites a
16-byte access holds and every plane is 16-byte aligned, one element a
step otherwise: ``form``), and raises on anything else: planes of
another dtype, shape or device, fields without 12 channels, weights not
[12] on the fields' device, another device.  The kernel rounds as the
plain version's separate passes do, so the two agree bit for bit.  The
output is a new CArray.  Each launch adds the bytes of the planes it
reads and writes to the tracker's ``dw_s5.bytes``.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from ..cplx import CArray
from ..utils import tracker
from . import _cuda
from ._guard import refuse_dtensor

__all__ = ["dw_s5", "dw_s5_reference", "form", "PASSES", "FORMS", "DTYPES"]

#: the passes, by their number at the C entry
PASSES = ("right_pre", "right_post", "left", "shamir")
#: the kernel's forms, by their number at the C entry
FORMS = ("elem", "vec16")
#: the planes' dtypes the kernel takes
DTYPES = (torch.float32, torch.float64)
#: the most blocks of 256 threads a grid takes an SM: as many as the
#: kernel's launch bounds keep resident, so a grid is one wave
BLOCKS_PER_SM = 2
FEATURES = 12


def dw_s5_reference(kind: str, x: CArray, y: Optional[CArray], wp: torch.Tensor,
                    wm: torch.Tensor, bulk: float, wall: float, b5: float = 1.0,
                    c5: float = 0.0) -> CArray:
    """Plain version of :func:`dw_s5`: PyTorch's rolls, broadcast products
    and sums, the walls built as [Ls] tensors of the field's dtype."""
    Ls, rest = x.re.shape[1], tuple(x.re.shape[2:])
    dt, dev = x.re.dtype, x.re.device
    shape_c = (1, Ls, 1) + (1,) * (len(rest) - 1)
    shape_f = (1, 1, rest[0]) + (1,) * (len(rest) - 1)

    def lam(at):
        """[Ls] factors, bulk but wall at s = at"""
        w = torch.full((Ls,), bulk, dtype=dt, device=dev)
        w[at] = wall
        return w.reshape(shape_c)

    hp = lam(Ls - 1) * wp.to(dt).reshape(shape_f)
    hm = lam(0) * wm.to(dt).reshape(shape_f)

    def H(a):
        return hp * torch.roll(a, -1, dims=1) + hm * torch.roll(a, 1, dims=1)

    if kind == "right_pre":
        return CArray(*(b5 * a + c5 * H(a) for a in x))
    if kind == "right_post":
        return CArray(*(c + a - H(a) for a, c in zip(x, y)))
    if kind == "left":
        return CArray(*(b5 * c + a + H(c5 * c - a) for a, c in zip(x, y)))
    return CArray(*(c + H(a) for a, c in zip(x, y)))


def _problem(kind, x, y, wp, wm) -> Optional[str]:
    """What ``dw_s5`` does not take in these operands, None where it
    takes them."""
    if kind not in PASSES:
        return f"pass {kind!r}, not one of {PASSES}"
    if (y is None) != (kind == "right_pre"):
        return f"pass {kind!r} {'takes no' if y is None else 'needs a'} second field"
    planes = [*x] + ([] if y is None else [*y])
    ref = planes[0]
    for t in planes:
        if (not isinstance(t, torch.Tensor) or t.dtype not in DTYPES or t.dtype != ref.dtype
                or t.dim() < 4 or t.shape != ref.shape or t.device != ref.device):
            return (f"f32 or f64 planes [n, Ls, 12, ...] of one dtype and shape on one device, "
                    f"got {getattr(t, 'dtype', type(t))} {tuple(getattr(t, 'shape', ()))} on "
                    f"{getattr(t, 'device', None)} beside {ref.dtype} {tuple(ref.shape)}")
    if ref.shape[2] != FEATURES or ref.numel() == 0:
        return f"fields [n, Ls, 12, ...] with sites, got {tuple(ref.shape)}"
    for w in (wp, wm):
        if tuple(w.shape) != (FEATURES,) or w.device != ref.device:
            return f"weights [12] on {ref.device}, got {tuple(w.shape)} on {w.device}"
    return None


def form(V: int, *planes: torch.Tensor) -> str:
    """The kernel's form: "vec16" where the ``V`` sites a plane are a
    multiple of the sites a 16-byte access holds (4 f32, 2 f64) and every
    data pointer is 16-byte aligned, else "elem"."""
    per = 16 // planes[0].element_size()
    return "vec16" if V % per == 0 and all(t.data_ptr() % 16 == 0 for t in planes) else "elem"


def dw_s5(kind: str, x: CArray, y: Optional[CArray], wp: torch.Tensor, wm: torch.Tensor,
          bulk: float, wall: float, b5: float = 1.0, c5: float = 0.0) -> CArray:
    """One s5 pass ``kind`` (:data:`PASSES`) of x [n, Ls, 12, *lat] (and
    K1's output y, None for "right_pre"), as a new CArray."""
    refuse_dtensor("dw_s5", "models.domain_wall.apply_domain_wall", *x,
                   *(() if y is None else y))
    problem = _problem(kind, x, y, wp, wm)
    if problem is not None:
        raise ValueError(f"dw_s5: {problem}")
    if not _cuda.on_card("dw_s5", x.re):
        return dw_s5_reference(kind, x, y, wp, wm, bulk, wall, b5, c5)
    dev, dt = x.re.device, x.re.dtype
    x = CArray(*(t.contiguous() for t in x))
    y = None if y is None else CArray(*(t.contiguous() for t in y))
    wp, wm = (w.to(dt).contiguous() for w in (wp, wm))
    n, Ls = x.re.shape[:2]
    V = math.prod(x.re.shape[3:])
    out = CArray(torch.empty_like(x.re), torch.empty_like(x.im))
    planes = [*x, *out] + ([] if y is None else [*y])
    f = form(V, *planes)
    yp = (None, None) if y is None else (y.re.data_ptr(), y.im.data_ptr())
    _cuda.launch("sbt_dw_s5", dev, PASSES.index(kind), int(dt == torch.float64),
                 FORMS.index(f), n, Ls, V, x.re.data_ptr(), x.im.data_ptr(), *yp,
                 out.re.data_ptr(), out.im.data_ptr(), wp.data_ptr(), wm.data_ptr(), b5, c5,
                 bulk, wall, _cuda.grid_cap(dev, BLOCKS_PER_SM))
    dw_s5.launches += 1
    dw_s5.by_pass[kind] += 1
    dw_s5.by_form[f] += 1
    tracker.count("dw_s5.bytes", len(planes) * out.re.nbytes)
    return out


dw_s5.launches = 0
dw_s5.by_pass = collections.Counter()
dw_s5.by_form = collections.Counter()
