"""Split-complex tensors (counterpart of ``superbblas_tpu/cplx.py``).

    CArray(re, im)   -- a pair of same-shaped real torch tensors.

The split layout is kept rather than ``torch.complex64`` because the
stencil kernel's contract is separate re/im structure-of-arrays planes.
Contractions use the 3-multiplication Gauss/Karatsuba decomposition

    (a+ib)(c+id): k1 = a(c+d), k2 = d(a+b), k3 = c(b-a)
                  re = k1 - k2, im = k1 + k3
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "CArray", "asarray", "from_complex", "to_complex", "is_carray",
    "cmap", "conj", "scale", "add", "cbilinear", "cdot_general", "cmatmul",
    "inner_real",
]


class CArray(NamedTuple):
    """Complex tensor as (real, imaginary) parts."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def device(self):
        return self.re.device

    def to(self, *args, **kwargs) -> "CArray":
        return CArray(self.re.to(*args, **kwargs), self.im.to(*args, **kwargs))


def is_carray(x) -> bool:
    return isinstance(x, CArray)


def from_complex(x) -> CArray:
    """Split a complex numpy array or tensor; real inputs get zero imag."""
    if isinstance(x, CArray):
        return x
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            rdt = np.float32 if x.dtype == np.complex64 else np.float64
            return CArray(torch.from_numpy(np.ascontiguousarray(x.real, rdt)),
                          torch.from_numpy(np.ascontiguousarray(x.imag, rdt)))
        x = torch.from_numpy(x)
    if x.is_complex():
        return CArray(x.real.contiguous(), x.imag.contiguous())
    return CArray(x, torch.zeros_like(x))


def asarray(x):
    """CArray for complex inputs (numpy arrays or tensors), a plain tensor
    otherwise."""
    if isinstance(x, CArray):
        return x
    if (isinstance(x, np.ndarray) and np.iscomplexobj(x)) or (
            isinstance(x, torch.Tensor) and x.is_complex()):
        return from_complex(x)
    return torch.as_tensor(x)


def to_complex(c) -> torch.Tensor:
    """Merge back to a complex tensor."""
    if not isinstance(c, CArray):
        return c
    return torch.complex(c.re, c.im)


def _as_carray(c) -> CArray:
    return c if isinstance(c, CArray) else CArray(c, torch.zeros_like(c))


def cmap(f, *cs):
    """Apply a structural (linear, part-wise) function to both parts."""
    cs2 = [_as_carray(c) for c in cs]
    return CArray(f(*[c.re for c in cs2]), f(*[c.im for c in cs2]))


def conj(c):
    if isinstance(c, CArray):
        return CArray(c.re, -c.im)
    return torch.conj(c)


def _split_scalar(alpha):
    """(re, im) of a complex scalar: a Python or numpy complex, a complex
    0-dim tensor or a CArray; (alpha, None) for a real one."""
    if isinstance(alpha, CArray):
        return alpha.re, alpha.im
    if isinstance(alpha, (complex, np.complexfloating)) or (
            isinstance(alpha, torch.Tensor) and alpha.is_complex()):
        return alpha.real, alpha.imag
    return alpha, None


def scale(alpha, c):
    """alpha * c with real or complex alpha (a Python number, a 0-dim
    tensor or a CArray of 0-dim tensors)."""
    if not isinstance(c, CArray):
        if isinstance(alpha, CArray):
            return CArray(alpha.re * c, alpha.im * c)
        return alpha * c
    ar, ai = _split_scalar(alpha)
    if ai is None or (isinstance(ai, (int, float)) and ai == 0):
        return CArray(ar * c.re, ar * c.im)
    return CArray(ar * c.re - ai * c.im, ar * c.im + ai * c.re)


def add(a, b):
    if not isinstance(a, CArray) and not isinstance(b, CArray):
        return a + b
    a, b = _as_carray(a), _as_carray(b)
    return CArray(a.re + b.re, a.im + b.im)


def cbilinear(f, a, b):
    """Lift a real bilinear kernel f(x, y) to split-complex operands via
    the 3-multiplication Gauss/Karatsuba scheme."""
    if not isinstance(a, CArray) and not isinstance(b, CArray):
        return f(a, b)
    if isinstance(a, CArray) and not isinstance(b, CArray):
        return CArray(f(a.re, b), f(a.im, b))
    if not isinstance(a, CArray) and isinstance(b, CArray):
        return CArray(f(a, b.re), f(a, b.im))
    k1 = f(a.re, b.re + b.im)
    k2 = f(a.re + a.im, b.im)
    k3 = f(a.im - a.re, b.re)
    return CArray(k1 - k2, k1 + k3)


@contextlib.contextmanager
def _full_f32():
    """f32 products in full f32 on the card, the counterpart of
    ``lax.Precision.HIGHEST``: TF32 is switched off
    (``torch.backends.cuda.matmul.allow_tf32 = False``) for the duration
    and restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def cdot_general(a, b, dimension_numbers, preferred_element_type=None,
                 precision=None):
    """``lax.dot_general`` over split-complex operands via 3 real
    contractions.  ``dimension_numbers`` = ((lhs_contract, rhs_contract),
    (lhs_batch, rhs_batch)); the output is batch dims, then lhs free,
    then rhs free dims, as in ``lax.dot_general``.

    ``preferred_element_type``: the type the products are formed and
    summed in, and the result's.  The Gauss sums (``b.re + b.im``, ...)
    are formed in the operand type, as in JAX; the operands of each real
    contraction are then converted, so bf16 operands give exact f32
    products, f32 sums and f32 ``k1 - k2``/``k1 + k3``, rounded only where
    the caller casts the result.  ``precision``: None or "highest", both
    full f32 (TF32 off); other precisions come with ``flags.py``."""
    if precision not in (None, "highest"):
        raise ValueError(f"precision={precision!r}: only None and 'highest' are "
                         "ported (the other precisions come with flags.py, "
                         "ROADMAP.md Queue 1 item 12)")
    (lc, rc), (lb, rb) = dimension_numbers

    def dg(x, y):
        if preferred_element_type is not None:
            x, y = x.to(preferred_element_type), y.to(preferred_element_type)
        letters = iter("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
        xs = [next(letters) for _ in range(x.ndim)]
        ys = [next(letters) for _ in range(y.ndim)]
        for i, j in zip(lc, rc):
            ys[j] = xs[i]
        for i, j in zip(lb, rb):
            ys[j] = xs[i]
        out = ([xs[i] for i in lb]
               + [xs[i] for i in range(x.ndim) if i not in lc and i not in lb]
               + [ys[j] for j in range(y.ndim) if j not in rc and j not in rb])
        with _full_f32():
            return torch.einsum(f"{''.join(xs)},{''.join(ys)}->{''.join(out)}", x, y)

    return cbilinear(dg, a, b)


def cmatmul(a, b, preferred_element_type=None):
    """a @ b over split-complex (or real) operands: a's last axis against
    b's second-to-last (its only one for a vector), no batch axes, as
    ``lax.dot_general`` orders the output."""
    dims = (((a.ndim - 1,), (max(b.ndim - 2, 0),)), ((), ()))
    return cdot_general(a, b, dims, preferred_element_type)


def inner_real(a, b):
    """Re <a, b> = sum(a.re*b.re + a.im*b.im) (works for plain tensors too),
    as a 0-dim tensor on the operands' device."""
    if isinstance(a, CArray) or isinstance(b, CArray):
        a, b = _as_carray(a), _as_carray(b)
        return torch.sum(a.re * b.re) + torch.sum(a.im * b.im)
    return torch.sum(a * b)
