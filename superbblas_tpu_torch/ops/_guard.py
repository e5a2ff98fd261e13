"""The kernel wrappers' guard against sharded operands: a DTensor never
reaches a kernel (no hidden gather, no fallback).  The error names the
``parallel`` function that runs the kernel on each rank's local shard.
The check costs a module lookup while no DTensor module is loaded.
``is_sharded`` is the test the ordinary entry points (``bsr``, ``models``,
``ops.copy``, ``ops.contract``) make one level up, to send sharded
operands to the ``parallel`` functions before any wrapper sees them."""

from __future__ import annotations

import sys


def refuse_dtensor(name: str, hint: str, *tensors) -> None:
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return
    cls = mod.DTensor
    for t in tensors:
        for a in (t if isinstance(t, tuple) else (t,)):
            if isinstance(a, cls):
                raise ValueError(f"{name}: a sharded DTensor operand; use {hint}, which "
                                 "runs the kernel on each rank's local shard")


def is_sharded(*tensors) -> bool:
    """True where any of ``tensors`` (tensors, CArrays or tuples of them)
    is a DTensor: the ordinary entry points then take the ``parallel``
    path, which runs the kernels on each rank's local shard."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return False
    cls = mod.DTensor
    for t in tensors:
        for a in (tuple(t) if isinstance(t, tuple) else (t,)):
            if isinstance(a, cls):
                return True
    return False
