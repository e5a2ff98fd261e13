"""bf16 roll-plus-add along the minor axis, E2 (counterpart of the probe
``experiments/stencil_bf16_roll_probe.py``):

    y[r, z, t] = x[r, z, (t - 1) mod T] + x[r, z, t]

on a bf16 tensor [R, Z, T] (any leading shape: the rows are everything but
the last axis).  ``roll_add`` runs the plain version on CPU tensors and
the kernel ``csrc/roll_add.cu`` on CUDA ones, in one of two variants:
``"f32"`` (convert, add in f32, round once; bit-exact against the plain
version) or ``"bf16x2"`` (native bf16 pair adds; within one bf16 ulp of
it, on 4-byte aligned pairs only), and in the form ``roll_add_form`` picks
from the shape and the pointers' alignment: ``"vec16"`` (16-byte words),
``"pair"`` (4-byte pairs) or ``"elem"`` (one element a thread).  It
answers whether native bf16 arithmetic pays on the card; nothing in the
package calls it.
"""

from __future__ import annotations

import collections

import torch

from . import _cuda

__all__ = ["roll_add", "roll_add_reference", "roll_add_form", "VARIANTS", "FORMS"]

VARIANTS = ("f32", "bf16x2")
#: the kernel's forms, by their number at its C entry
FORMS = ("vec16", "pair", "elem")


def roll_add_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the roll and the add in f32, rounded once to
    x's dtype."""
    xf = x.float()
    return (torch.roll(xf, 1, dims=-1) + xf).to(x.dtype)


def roll_add_form(T: int, x_ptr: int, y_ptr: int, variant: str = "f32") -> str:
    """The kernel's form for rows of ``T`` bf16 at the data pointers
    ``x_ptr`` and ``y_ptr``: "vec16" where T % 8 == 0 and both are 16-byte
    aligned, "pair" where T is even and both are 4-byte aligned, else
    "elem" (the f32 variant only: the bf16x2 variant raises ValueError)."""
    if T % 8 == 0 and x_ptr % 16 == 0 and y_ptr % 16 == 0:
        return "vec16"
    if T % 2 == 0 and x_ptr % 4 == 0 and y_ptr % 4 == 0:
        return "pair"
    if variant == "bf16x2":
        raise ValueError(f"roll_add: the bf16x2 variant adds 4-byte aligned pairs and takes "
                         f"an even last axis on aligned data, got {T}")
    return "elem"


def roll_add(x: torch.Tensor, variant: str = "f32") -> torch.Tensor:
    """``roll(x, 1, -1) + x`` of a bf16 tensor.  CPU tensors run the plain
    version; CUDA tensors the kernel's ``variant`` in the form
    :func:`roll_add_form` picks (``roll_add.launches`` counts its launches,
    ``roll_add.by_form`` them by form and ``roll_add.by_variant_form`` by
    (variant, form)) or raise where it does not take the case."""
    if variant not in VARIANTS:
        raise ValueError(f"roll_add: variant {variant!r} is not one of {VARIANTS}")
    if x.dtype != torch.bfloat16 or x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"roll_add: a non-empty bf16 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if torch.compiler.is_compiling():
        return torch.ops.sbt.roll_add(x, variant)
    if not _cuda.on_card("roll_add", x):
        return roll_add_reference(x)
    T = x.shape[-1]
    if variant == "bf16x2" and T % 2:
        raise ValueError(f"roll_add: the bf16x2 variant loads pairs and takes an even "
                         f"last axis, got {T}")
    if not x.is_contiguous():
        raise ValueError("roll_add: the kernel takes a contiguous tensor")
    y = torch.empty_like(x)
    form = roll_add_form(T, x.data_ptr(), y.data_ptr(), variant)
    # the entry takes the SM count and caps its grid at its own blocks an SM
    _cuda.launch("sbt_roll_add", x.device, int(variant == "bf16x2"), FORMS.index(form),
                 x.numel() // T, T, x.data_ptr(), y.data_ptr(), _cuda.grid_cap(x.device, 1))
    roll_add.launches += 1
    roll_add.by_form[form] += 1
    roll_add.by_variant_form[variant, form] += 1
    return y


roll_add.launches = 0
roll_add.by_form = collections.Counter()
roll_add.by_variant_form = collections.Counter()


@torch.library.custom_op("sbt::roll_add", mutates_args=())
def _roll_add_op(x: torch.Tensor, variant: str) -> torch.Tensor:
    """:func:`roll_add` as an op of a traced program."""
    return roll_add(x, variant)


@_roll_add_op.register_fake
def _(x, variant):
    return torch.empty_like(x)
