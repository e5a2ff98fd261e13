"""Label-driven tensor contraction (counterpart of
``superbblas_tpu/ops/contract.py``).

The reference's contraction engine (``include/superbblas/tensor.h:1271-1637``
in eromero-vlc/superbblas) classifies labels into T (batch) / A
(contracted) / B / C groups.  Here the classification
(``labels.ContractionPlan``) becomes the dimension numbers of one
``cplx.cdot_general`` (``torch.einsum``, cuBLAS on the card; no
hand-written kernel, as the JAX package leaves it to XLA), whose output
is put into the result's label order by ``local_permute``.

    r = alpha * contraction(op0(x0), op1(x1)) + beta * r

where opN is optional element-wise conjugation.  Every label must fall in
a group ("unmatched dimensions" otherwise).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import cplx
from ..labels import ContractionPlan
from ..utils.tracker import tracked as _tracked
from ._guard import is_sharded
from .copy import _is_static, local_permute

__all__ = ["local_contraction"]


def _accum_type(dt):
    """Accumulation dtype: f32 for f32/bf16/f16, else the input's."""
    if dt in (torch.bfloat16, torch.float16, torch.float32):
        return torch.float32
    return dt


@_tracked("local_contraction")
def local_contraction(
    alpha,
    x0,
    o0: str,
    conj0: bool,
    x1,
    o1: str,
    conj1: bool,
    beta,
    r,
    o_r: str,
    dimr: Optional[tuple] = None,
    dtype=None,
    precision=None,
):
    """Contract two labeled tensors; returns alpha * x0·x1 + beta * r.

    ``r`` may be None when beta == 0; then ``dimr``/``dtype`` give the output
    spec (defaulting to the deduced extents and the promoted input dtype).
    Operands may be split-complex ``cplx.CArray``s; the contraction then
    runs as 3 real contractions (Gauss trick).  Products are formed and
    summed in f32 for bf16/f16/f32 operands, and the result is rounded to
    ``dtype`` once, at the end.  The result lies on the operands' device.
    Sharded operands (DTensors, or CArrays of them) go to
    ``parallel.contraction``: the local shards are contracted and the mesh
    axes that shard a contracted label all-reduced.
    """
    if is_sharded(x0, x1, r):
        from ..parallel.dist import contraction as dist_contraction

        if precision is not None:
            raise ValueError("local_contraction: ``precision`` on sharded operands; "
                             "parallel.contraction contracts at the default precision")
        out = dist_contraction(alpha, x0, o0, conj0, x1, o1, conj1, beta, r, o_r)
        return out if dtype is None or r is not None else cplx.cmap(
            lambda a: a.to(dtype), out) if cplx.is_carray(out) else out.to(dtype)
    if r is not None:
        dimr = tuple(r.shape)
        dtype = r.dtype
    else:
        if not (_is_static(beta) and beta == 0):
            raise ValueError("contraction: r must be given unless beta == 0")
        if dimr is None:
            d = {**dict(zip(o0, x0.shape)), **dict(zip(o1, x1.shape))}
            dimr = tuple(d[c] for c in o_r)
        if dtype is None:
            dtype = torch.promote_types(x0.dtype, x1.dtype)

    plan = ContractionPlan(o0, tuple(x0.shape), o1, tuple(x1.shape), o_r, dimr)

    if conj0 and (cplx.is_carray(x0) or x0.is_complex()):
        x0 = cplx.conj(x0)
    if conj1 and (cplx.is_carray(x1) or x1.is_complex()):
        x1 = cplx.conj(x1)

    out = cplx.cdot_general(
        x0,
        x1,
        dimension_numbers=plan.dot_general_dims(),
        preferred_element_type=_accum_type(torch.promote_types(x0.dtype, x1.dtype)),
        precision=precision,
    )
    out = local_permute(out, plan.dot_general_out_order(), o_r)

    if not (_is_static(alpha) and alpha == 1):
        out = cplx.scale(alpha, out)
    out = out.to(dtype)
    if r is not None and not (_is_static(beta) and beta == 0):
        if _is_static(beta) and beta == 1:
            out = cplx.add(out, r)
        else:
            out = cplx.add(out, cplx.scale(beta, r))
    return out
