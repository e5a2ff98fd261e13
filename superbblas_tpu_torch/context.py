"""Execution contexts and asynchrony: the platform layer (counterpart of
``superbblas_tpu/context.py``).

The reference's L1 (platform.h) manages CPU/GPU contexts, streams,
causality and BLAS handles; in PyTorch those concerns are the
``torch.device`` and the CUDA streams.  This module provides:

  * ``Context``            <-> Context{plat, device} (platform.h:757-816)
  * ``create_cpu_context`` / ``create_gpu_context`` (createGpuContext)
  * ``create_context``     the card's context; it raises where there is no
                           card (the JAX package falls back to the CPU;
                           this port moves nothing to the CPU behind the
                           caller's back)
  * ``make_sure``          <-> makeSure (copy a tensor to another context,
                                blas.h:813-845)
  * ``Request`` / ``wait`` <-> Request/wait (dist.h:54-61): CUDA launches
    are asynchronous the same way the reference's streams are, and
    ``wait`` blocks on completion.
  * ``concurrent``         an NVTX range only, as the JAX scope is an
                           annotation only (anabranch, blas.h:928-960).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils import _pytree

from . import cplx
from .utils import tracker

__all__ = ["Context", "create_cpu_context", "create_gpu_context",
           "create_context", "make_sure", "Request", "wait", "concurrent"]


@dataclass(frozen=True)
class Context:
    """A compute placement handle (public Context, platform.h:757-780):
    platform "cpu" or "cuda" and the device's index."""

    platform: str
    device_index: int = 0

    @property
    def device(self) -> torch.device:
        if self.platform == "cpu":
            return torch.device("cpu")
        return torch.device(self.platform, self.device_index)


def create_cpu_context() -> Context:
    return Context("cpu", 0)


def create_gpu_context(device: int = 0) -> Context:
    """CUDA context (createGpuContext, platform.h:783-816); raises where
    there is no such card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available")
    if not 0 <= device < torch.cuda.device_count():
        raise RuntimeError(f"CUDA device {device} out of range "
                           f"({torch.cuda.device_count()} devices)")
    return Context("cuda", device)


def create_context(device: int = 0) -> Context:
    """The card's context.  Unlike the JAX package, which falls back to
    the CPU, this raises where there is no card: entry points of this
    port run on the card unless the caller names the CPU
    (:func:`create_cpu_context`)."""
    return create_gpu_context(device)


def make_sure(x, ctx: Context):
    """Return ``x`` resident on ``ctx`` (makeSure, blas.h:813-845); a
    tensor or ``cplx.CArray`` already there is returned as it is."""
    if cplx.is_carray(x):
        return cplx.cmap(lambda a: a.to(ctx.device), x)
    return x.to(ctx.device)


Request = Any  # any pytree of tensors doubles as an async handle


def wait(request: Request) -> Request:
    """Block until an async result is complete (wait, dist.h:56-61):
    synchronises the CUDA devices of the tensors in the pytree and returns
    it.  Futures in it (``storage.save_async``) are resolved."""
    for leaf in _pytree.tree_leaves(request):
        if hasattr(leaf, "result") and hasattr(leaf, "done"):
            leaf.result()
    tracker.synchronize(request)
    return request


@contextmanager
def concurrent(name: str = "concurrent"):
    """Fork/join scope for API parity with anabranch_begin/end
    (blas.h:928-960): an NVTX range where CUDA is initialised, and a
    profiler range, around the region; it changes no stream."""
    with tracker.ranges(name):
        yield
