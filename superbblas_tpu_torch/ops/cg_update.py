"""The vector updates and inner products of one conjugate-gradient
iteration, fused (``csrc/cg_update.cu``), on split-complex f32 fields
(``CArray``s of contiguous planes of one size):

    cg_dot(p, q)                      Re<p, q>
    cg_xr(x, p, r, q, rs, pap, ...)   alpha = rs / max(pap, 1e-30);
                                      x + alpha p, r - alpha q, and |r - alpha q|^2
    cg_p(r, p, rs_new, rs, bs, ...)   beta = rs_new / max(rs, 1e-30);
                                      r + beta p, and rs_new / bs

``solvers.cg`` runs its iteration on these where its operands are CUDA
fields (q = A p).  The scalars are 0-dim f32 tensors on the fields'
device, read and written there; the fields' results go into the ``*_out``
CArrays given, which may be the inputs themselves (updates in place).
CPU tensors run the plain versions, whose products and sums round as the
kernels' do (PyTorch's separate passes); CUDA tensors launch the kernel,
in the 16-byte form where every plane is 16-byte aligned and one element
a step otherwise (``form``), or raise.  A reduction writes one partial a
block into a ``workspace`` that the calls of one solve share.
"""

from __future__ import annotations

import collections

import torch

from ..cplx import CArray
from . import _cuda
from ._guard import refuse_dtensor

__all__ = ["cg_dot", "cg_xr", "cg_p", "cg_dot_reference", "cg_xr_reference",
           "cg_p_reference", "workspace", "form", "FORMS"]

#: the kernels' forms, by their number at the C entries
FORMS = ("elem", "vec16")
#: the most blocks of 256 threads a grid takes an SM: as many as the
#: kernels' launch bounds keep resident, so a grid is one wave
BLOCKS_PER_SM = 4


def cg_dot_reference(p: CArray, q: CArray) -> torch.Tensor:
    """Plain version of :func:`cg_dot`."""
    return torch.sum(p.re * q.re + p.im * q.im)


def cg_xr_reference(x: CArray, p: CArray, r: CArray, q: CArray, rs: torch.Tensor,
                    pap: torch.Tensor, x_out: CArray, r_out: CArray) -> torch.Tensor:
    """Plain version of :func:`cg_xr`."""
    alpha = rs / torch.clamp_min(pap, 1e-30)
    for o, a, b in zip(x_out, x, p):
        o.copy_(a + alpha * b)
    for o, a, b in zip(r_out, r, q):
        o.copy_(a - alpha * b)
    return cg_dot_reference(r_out, r_out)


def cg_p_reference(r: CArray, p: CArray, rs_new: torch.Tensor, rs: torch.Tensor,
                   bs: torch.Tensor, p_out: CArray) -> torch.Tensor:
    """Plain version of :func:`cg_p`."""
    beta = rs_new / torch.clamp_min(rs, 1e-30)
    for o, a, b in zip(p_out, r, p):
        o.copy_(a + beta * b)
    return rs_new / bs


def workspace(like: torch.Tensor):
    """The scratch the reductions of one solve share on ``like``'s device:
    a float a block and the ticket of the last block, zero between
    launches (one int32 tensor); None for a CPU tensor.  Calls that share
    one run in order on one stream."""
    if like.device.type != "cuda":
        return None
    return torch.zeros(_cuda.grid_cap(like.device, BLOCKS_PER_SM) + 1, dtype=torch.int32,
                       device=like.device)


def form(*planes: torch.Tensor) -> str:
    """The kernels' form for ``planes``: "vec16" where every data pointer
    is 16-byte aligned, else "elem"."""
    return "vec16" if all(t.data_ptr() % 16 == 0 for t in planes) else "elem"


def _check(name: str, fields, scalars) -> tuple:
    """The planes of ``fields`` (CArrays) and whether they go to the
    kernel (``_cuda.on_card``), after the checks every kernel makes:
    contiguous f32 planes of one size on one device (no DTensor:
    ``solvers.cg`` hands the kernels local shards), f32 0-dim scalars
    there."""
    planes = [t for f in fields for t in (f.re, f.im)]
    refuse_dtensor(name, "solvers.cg", *planes)
    ref = planes[0]
    for t in planes:
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                or t.device != ref.device or t.numel() != ref.numel() or not t.is_contiguous()):
            raise ValueError(f"{name}: contiguous f32 planes of one size on one device, got "
                             f"{getattr(t, 'dtype', type(t))} {tuple(getattr(t, 'shape', ()))} "
                             f"on {getattr(t, 'device', None)} beside {tuple(ref.shape)}")
    if ref.numel() == 0:
        raise ValueError(f"{name}: empty fields")
    for s in scalars:
        if s.dtype != torch.float32 or s.dim() != 0 or s.device != ref.device:
            raise ValueError(f"{name}: 0-dim f32 scalars on {ref.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    return planes, _cuda.on_card(name, ref)


def _launched(fn, f: str) -> None:
    fn.launches += 1
    fn.by_form[f] += 1


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def cg_dot(p: CArray, q: CArray, ws=None) -> torch.Tensor:
    """Re<p, q> as a 0-dim tensor (this rank's part for shards).  ``ws``:
    a :func:`workspace` of the device (a new one where None)."""
    planes, card = _check("cg_dot", (p, q), ())
    if not card:
        return cg_dot_reference(p, q)
    dev = p.re.device
    ws = workspace(p.re) if ws is None else ws
    out = torch.empty((), dtype=torch.float32, device=dev)
    f = form(*planes)
    _cuda.launch("sbt_cg_dot", dev, FORMS.index(f), planes[0].numel(), *_ptrs(planes),
                 ws.data_ptr(), ws.numel() - 1, out.data_ptr())
    _launched(cg_dot, f)
    return out


def cg_xr(x: CArray, p: CArray, r: CArray, q: CArray, rs: torch.Tensor, pap: torch.Tensor,
          x_out: CArray, r_out: CArray, ws=None) -> torch.Tensor:
    """Writes x + alpha p into ``x_out`` and r - alpha q into ``r_out``,
    alpha = rs / max(pap, 1e-30), and returns |r_out|^2 (this rank's part
    for shards) as a 0-dim tensor.  ``ws``: as :func:`cg_dot`'s."""
    planes, card = _check("cg_xr", (x, p, r, q, x_out, r_out), (rs, pap))
    if not card:
        return cg_xr_reference(x, p, r, q, rs, pap, x_out, r_out)
    dev = x.re.device
    ws = workspace(x.re) if ws is None else ws
    out = torch.empty((), dtype=torch.float32, device=dev)
    f = form(*planes)
    _cuda.launch("sbt_cg_xr", dev, FORMS.index(f), planes[0].numel(), *_ptrs(planes),
                 rs.data_ptr(), pap.data_ptr(), ws.data_ptr(), ws.numel() - 1, out.data_ptr())
    _launched(cg_xr, f)
    return out


def cg_p(r: CArray, p: CArray, rs_new: torch.Tensor, rs: torch.Tensor, bs: torch.Tensor,
         p_out: CArray) -> torch.Tensor:
    """Writes r + beta p into ``p_out``, beta = rs_new / max(rs, 1e-30),
    and returns rs_new / bs (the convergence test's ratio) as a 0-dim
    tensor."""
    planes, card = _check("cg_p", (r, p, p_out), (rs_new, rs, bs))
    if not card:
        return cg_p_reference(r, p, rs_new, rs, bs, p_out)
    dev = r.re.device
    ratio = torch.empty((), dtype=torch.float32, device=dev)
    f = form(*planes)
    _cuda.launch("sbt_cg_p", dev, FORMS.index(f), planes[0].numel(), *_ptrs(planes),
                 rs_new.data_ptr(), rs.data_ptr(), bs.data_ptr(), ratio.data_ptr(),
                 _cuda.grid_cap(dev, BLOCKS_PER_SM))
    _launched(cg_p, f)
    return ratio


for _fn in (cg_dot, cg_xr, cg_p):
    _fn.launches = 0
    _fn.by_form = collections.Counter()
