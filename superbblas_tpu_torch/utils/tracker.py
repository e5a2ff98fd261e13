"""Performance tracking: hierarchical call-path timing + roofline report
(counterpart of ``superbblas_tpu/utils/tracker.py``).

Re-creation of the reference's tracker subsystem
(``include/superbblas/performance.h:196-431`` in eromero-vlc/superbblas):
scopes build a "a/b/c" call path; each scope accumulates wall time, call
count, and flop/byte attributions; ``report_timings`` prints per-path
GFLOPS / GBYTES/s / arithmetic intensity.

  * A scope synchronises the CUDA device of ``sync_on``'s tensors before
    it stops the clock (kernel launches are asynchronous), and a tracked
    op the device of its outputs, so the time recorded is execution, not
    launch.
  * Every scope is also a ``torch.profiler.record_function`` range and,
    once CUDA is initialised, an NVTX range (the reference's NVTX
    integration, performance.h:17-22), so the same names show in
    profiler traces.

Enabled by SBT_TRACK_TIME=1 (flags.py) or force=True.  With it off, a
tracked op costs one cached read of the environment.  Memory accounting
(performance.h:457-518) reads the CUDA caching allocator
(``torch.cuda.memory_allocated``) and the live tensors the garbage
collector knows of.
"""

from __future__ import annotations

import functools
import gc
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict

import torch
from torch.utils import _pytree

from .. import flags

__all__ = ["track", "tracked", "get_timings", "reset_timings",
           "report_timings", "report_memory_usage", "memory_snapshot",
           "check_for_memory_leaks"]


@dataclass
class _PathStats:
    calls: int = 0
    seconds: float = 0.0
    flops: float = 0.0
    memops: float = 0.0


_stats: Dict[str, _PathStats] = {}
_local = threading.local()
_lock = threading.Lock()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def synchronize(tree) -> None:
    """Wait for the CUDA devices that hold ``tree``'s tensors."""
    devices = {leaf.device for leaf in _pytree.tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextmanager
def ranges(name: str):
    """A profiler range and, once CUDA is initialised, an NVTX range."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextmanager
def track(name: str, flops: float = 0.0, memops: float = 0.0,
          sync_on=None, force: bool = False):
    """Track a scope under the hierarchical path of enclosing scopes.

    ``sync_on``: a pytree of tensors whose CUDA devices are synchronised
    before the clock stops (otherwise only launch time is measured).
    """
    if not (force or flags.get_track_time()):
        yield
        return
    stack = _stack()
    path = "/".join(stack + [name])
    stack.append(name)
    t0 = time.perf_counter()
    try:
        with ranges(name):
            yield
            if sync_on is not None:
                synchronize(sync_on)
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        with _lock:
            st = _stats.setdefault(path, _PathStats())
            st.calls += 1
            st.seconds += dt
            st.flops += flops
            st.memops += memops


def tracked(name: str, flops_fn=None, memops_fn=None):
    """Decorator instrumenting a public op with a tracker scope.

    With SBT_LOG and SBT_TRACK_TIME off it costs one cached read of the
    environment (``flags.wrapper_state``).  With tracking on, the scope
    synchronises the devices of the op's outputs, so the recorded time is
    execution, not launch (the reference records GPU event pairs the same
    way, performance.h:282-330).  ``flops_fn(out, *args, **kwargs)``
    supplies the flop attribution, ``memops_fn`` the bytes; both land
    under the same hierarchical path as the time."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            log, timing = flags.wrapper_state()
            if not (log or timing):
                return fn(*args, **kwargs)
            if log:
                flags.log(1, name)
            if not timing:
                return fn(*args, **kwargs)
            # attribute flops under the SAME hierarchical path track()
            # times under (the enclosing-scope stack + this name)
            path = "/".join(_stack() + [name])
            with track(name):
                out = fn(*args, **kwargs)
                synchronize(out)
            if flops_fn is not None or memops_fn is not None:
                try:
                    fl = float(flops_fn(out, *args, **kwargs)) if flops_fn else 0.0
                    mem = float(memops_fn(out, *args, **kwargs)) if memops_fn else 0.0
                except Exception:
                    fl = mem = 0.0
                with _lock:
                    st = _stats.setdefault(path, _PathStats())
                    st.flops += fl
                    st.memops += mem
            return out
        return wrapper
    return deco


def get_timings() -> Dict[str, dict]:
    """Snapshot of the accumulated stats (performance.h:105 analog)."""
    with _lock:
        return {
            k: dict(calls=v.calls, seconds=v.seconds, flops=v.flops,
                    memops=v.memops)
            for k, v in _stats.items()
        }


def reset_timings() -> None:
    with _lock:
        _stats.clear()


def report_timings(out=None) -> str:
    """Per-call-path report: calls, time, GFLOPS, GBYTES/s, intensity
    (performance.h:364-431 analog).  Returns the formatted string and
    optionally writes it to ``out``."""
    lines = ["Timing of superbblas_tpu kernels:",
             f"{'path':40s} {'calls':>8s} {'time(s)':>10s} "
             f"{'GFLOPS':>10s} {'GBYTES/s':>10s} {'intensity':>10s}"]
    timings = get_timings()
    for path in sorted(timings):
        st = timings[path]
        t = max(st["seconds"], 1e-12)
        gf = st["flops"] / t / 1e9
        gb = st["memops"] / t / 1e9
        inten = st["flops"] / max(st["memops"], 1.0)
        lines.append(f"{path:40s} {st['calls']:8d} {st['seconds']:10.4f} "
                     f"{gf:10.1f} {gb:10.1f} {inten:10.2f}")
    txt = "\n".join(lines)
    if out is not None:
        print(txt, file=out)
    return txt


def _cuda_devices():
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _live_cpu_tensors():
    """(count, bytes) of the CPU tensors the garbage collector knows of,
    each storage counted once."""
    seen, count, nbytes = set(), 0, 0
    for obj in gc.get_objects():
        try:
            if not (issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu"):
                continue
            count += 1
            st = obj.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                nbytes += st.nbytes()
        except Exception:  # tensors without storage (meta, fake)
            continue
    return count, nbytes


def report_memory_usage() -> dict:
    """Device-memory statistics (memory tracking analog,
    performance.h:457-518): per CUDA device the allocator's bytes in use
    and their peak (``torch.cuda.memory_stats``), and ``live_array_bytes``,
    the bytes of live tensors on every device."""
    usage = {}
    live = 0
    for dev in _cuda_devices():
        ms = torch.cuda.memory_stats(dev)
        usage[str(dev)] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": ms.get("reserved_bytes.all.current", 0),
        }
        live += torch.cuda.memory_allocated(dev)
    usage["live_array_bytes"] = live + _live_cpu_tensors()[1]
    return usage


def memory_snapshot() -> dict:
    """Live-tensor accounting snapshot for leak checking
    (getCpuMemUsed/getGpuMemUsed analog, performance.h:53-63): the CUDA
    allocator's bytes plus the live CPU tensors' storage bytes."""
    count, nbytes = _live_cpu_tensors()
    for dev in _cuda_devices():
        nbytes += torch.cuda.memory_allocated(dev)
    return {"count": count, "bytes": int(nbytes)}


def check_for_memory_leaks(baseline: dict, tol_bytes: int = 0) -> None:
    """Raise if live memory grew past the baseline snapshot
    (checkForMemoryLeaks, performance.h:497-518; the reference's tests
    call it at exit under SB_TRACK_MEM=1).  Collects garbage first."""
    gc.collect()
    now = memory_snapshot()
    grew = now["bytes"] - baseline["bytes"]
    if grew > tol_bytes:
        raise RuntimeError(
            f"memory leak: live tensor bytes grew by {grew} "
            f"({baseline['count']} -> {now['count']} tensors)")
