"""The kernel wrappers' guard against sharded operands: a DTensor never
reaches a kernel (no hidden gather, no fallback).  The error names the
``parallel`` function that runs the kernel on each rank's local shard.
The check costs a module lookup while no DTensor module is loaded."""

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
