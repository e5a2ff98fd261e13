"""Ahead-of-time capture and program export (counterpart of
``superbblas_tpu/aot.py``).

The reference ships a template-instantiation build system (L8:
superbblas_lib.h + src/tools/ctemplate + src/Makefile:42-100) that
pre-compiles every (operation x dtype) instantiation so consumers avoid
recompilation; the JAX package lowers and compiles a function at concrete
shapes.  Here:

    exe = aot_compile(fn, example_args)        # CUDA graph, replayed
    path = export_compiled(fn, example_args, "op.pt2")
    fn2 = load_exported("op.pt2")              # callable, no retrace

``aot_compile`` captures ``fn`` on CUDA tensors in a ``torch.cuda.CUDAGraph``
(its kernel launches, ctypes ones included, replay with no host work of
``fn``); ``export_compiled`` saves a ``torch.export`` program, in which
K1, K2, K3 and E1 stand as the custom ops ``sbt::stencil_matvec_soa``,
``sbt::permute_4d``, ``sbt::batched_small_gemm`` and
``sbt::batched_gemm_rowpack``, so that the loaded program launches the
kernels.  The probe entries that nothing in the package calls
(``stencil_matvec_soa_rt``, ``_xin`` and ``_stream`` called directly,
``permute_4d_tiled``, ``roll_add``) have no op and cannot be exported on
CUDA tensors.  A captured graph and a loaded program both refuse arguments
whose shapes or dtypes differ from the example's, as a compiled XLA
executable does.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree

__all__ = ["aot_compile", "export_compiled", "load_exported"]


def _signature(args):
    """The pytree structure of ``args`` and each leaf's shape, dtype and
    device (a value for a leaf that is no tensor)."""
    leaves, spec = _pytree.tree_flatten(tuple(args))
    return spec, [(tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor)
                  else ("value", a) for a in leaves]


def _checked(example_args):
    """A check that arguments have the example's signature; returns the
    flat leaves of the arguments."""
    want = _signature(example_args)

    def check(args):
        got = _signature(args)
        if got != want:
            raise TypeError(f"arguments {got[1]} do not match the compiled signature "
                            f"{want[1]}")
        return _pytree.tree_leaves(tuple(args))
    return check


class _Graphed:
    """``fn`` captured in a CUDA graph at static input buffers: a call
    copies the arguments in, replays and returns the outputs, cloned."""

    def __init__(self, fn: Callable, example_args: Sequence[Any]):
        self._check = _checked(example_args)
        leaves, self._spec = _pytree.tree_flatten(tuple(example_args))
        self._inputs = [a.clone() if isinstance(a, torch.Tensor) else a for a in leaves]
        static = _pytree.tree_unflatten(self._inputs, self._spec)
        # warm-up on a side stream: builds every plan and cache fn needs
        # (host reads cannot run inside a capture)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._outputs = fn(*static)

    def __call__(self, *args):
        for dst, src in zip(self._inputs, self._check(args)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        self.graph.replay()
        return _pytree.tree_map(
            lambda a: a.clone() if isinstance(a, torch.Tensor) else a, self._outputs)


def aot_compile(fn: Callable, example_args: Sequence[Any]):
    """Capture ``fn`` at the example arguments' shapes and dtypes.

    On CUDA tensors: a CUDA graph of ``fn`` (warmed up on a side stream,
    then captured), replayed by each call after its arguments are copied
    into the graph's input buffers; the outputs are clones.  ``fn`` must
    be capturable: no host reads of device values after its warm-up.  On
    CPU tensors: ``fn`` itself behind the same argument check.
    """
    leaves = _pytree.tree_leaves(tuple(example_args))
    if any(isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in leaves):
        return _Graphed(fn, example_args)
    check = _checked(example_args)

    def call(*args):
        check(args)
        return fn(*args)
    return call


class _Module(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_compiled(fn: Callable, example_args: Sequence[Any], path: str,
                    platforms: Sequence[str] = None) -> str:
    """Save ``fn`` traced at the example arguments as a ``torch.export``
    program (``torch.export.save``).  ``platforms`` is accepted for the
    JAX package's signature and unused: the program runs on the devices
    of its example arguments."""
    mod = fn if isinstance(fn, torch.nn.Module) else _Module(fn)
    exported = torch.export.export(mod, tuple(example_args))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    return path


def load_exported(path: str) -> Callable:
    """Reload a saved program as a callable (no tracing); it refuses
    arguments whose shapes or dtypes differ from the traced ones."""
    return torch.export.load(path).module()
