"""Reduction and selection ops: the small-BLAS tail of the local engine
(counterpart of ``superbblas_tpu/ops/reduce.py``).

Reference counterparts (eromero-vlc/superbblas):
  * ``sum``    — blas.h:846-869 (thrust::reduce): here a label-driven
    partial reduction (sum over the labels dropped between o0 and o1).
  * ``select`` — blas.h:871-923 (thrust::copy_if mask compaction): host
    masks, exactly like the masked-copy path.
  * ``xscal``  — blas.h:529-556: in the functional model just alpha * x,
    provided for API parity.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cplx
from ..labels import check_order
from .copy import local_permute

__all__ = ["label_sum", "select", "scal"]


def label_sum(x, o0: str, o1: str):
    """Sum over the labels of ``o0`` that are absent from ``o1`` and
    permute the result into ``o1`` order."""
    check_order(o0)
    check_order(o1)
    for c in o1:
        if c not in o0:
            raise ValueError(f"label_sum: output label {c!r} not in {o0!r}")
    axes = tuple(i for i, c in enumerate(o0) if c not in o1)
    kept = "".join(c for c in o0 if c in o1)
    if cplx.is_carray(x):
        out = cplx.cmap(lambda a: torch.sum(a, dim=axes), x) if axes else x
    else:
        out = torch.sum(x, dim=axes) if axes else x
    return local_permute(out, kept, o1)


def select(x, mask: np.ndarray):
    """Compact the elements of ``x`` where the host-side ``mask`` is
    nonzero, in row-major scan order; returns a 1-D tensor of exactly
    ``mask.sum()`` elements on ``x``'s device."""
    mask = np.asarray(mask).astype(bool).reshape(-1)
    idx = torch.from_numpy(np.nonzero(mask)[0])
    if cplx.is_carray(x):
        idx = idx.to(x.re.device)
        return cplx.cmap(lambda a: a.reshape(-1)[idx], x)
    idx = idx.to(x.device)
    return x.reshape(-1)[idx]


def scal(alpha, x):
    """x *= alpha, functional (xscal, blas.h:529-556)."""
    return cplx.scale(alpha, x)
